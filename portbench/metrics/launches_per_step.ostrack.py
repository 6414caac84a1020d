"""Kernel launches in the traced window per frame step (one step: every
lane one frame) of OSTrack's batch engine (`tracker/ostrack_engine.py`);
the inits' launches are in the count."""


def read(ctx, out):
    if not out.trace or not out.counts.get("steps"):
        return None
    return out.trace["kernels"] / out.counts["steps"]
