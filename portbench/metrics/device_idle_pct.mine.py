"""Share of the traced window in which no operation ran on the device:
100 * (1 - busy / window), busy the union of the trace's kernel, copy
and fill intervals (`trace.reduce`)."""


def read(ctx, out):
    if not out.trace or out.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - out.trace["busy_s"] / out.trace["window_s"])
