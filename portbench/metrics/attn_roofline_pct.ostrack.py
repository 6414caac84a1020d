"""The OSTrack blocks' attention cores against their roofline: the least
time a step's 12 attention cores allow (`work_ostrack.attention_bound_s`
at the published kept-token counts) times the steps, over the device
seconds of the trace's fused attention kernels: FlashAttention's,
cuDNN's and the memory-efficient backend's of
`F.scaled_dot_product_attention`, known by name (CE's row, a float32
matrix-vector product beside them, is not among them)."""
import re

from portbench.metrics import work_ostrack

ATTENTION = re.compile(r"flash|fmha|sdpa|attention", re.IGNORECASE)


def read(ctx, out):
    if not out.trace or not out.counts.get("steps"):
        return None
    seconds = sum(v for k, v in out.trace["kernel_s"].items()
                  if ATTENTION.search(k))
    if seconds <= 0:
        return None
    bound = work_ostrack.attention_bound_s(
        work_ostrack.frozen(ctx.config["sizes"]), out.counts["lanes"])
    return 100.0 * bound * out.counts["steps"] / seconds
