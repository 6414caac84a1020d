"""Kernel launches in the traced window per PWCLite forward of the
mining loop (`preprocessing/inference.py`): the forwards' own, each
frame's upload and resize, each max|flow| read and each kept flow's
resize and copy, over the forwards the window ran."""


def read(ctx, out):
    if not out.trace or not out.counts.get("forwards"):
        return None
    return out.trace["kernels"] / out.counts["forwards"]
