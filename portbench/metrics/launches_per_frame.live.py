"""Kernel launches in the traced window per frame the B=1 tracker
(`tracker/tracker.py` through `tracker/runner.py`) tracked; the inits'
launches are in the count, the init frames not."""


def read(ctx, out):
    if not out.trace or not out.counts.get("frames"):
        return None
    return out.trace["kernels"] / out.counts["frames"]
