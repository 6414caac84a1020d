"""Kernel K1 (`ops/xcorr.py`'s fused GroupDW, `ops/csrc/xcorr_groupdw.cu`)
against its roofline: the least time its work allows, summed over the
frame steps' three calls (`work.k1_calls`: the two offline calls at
M=1 and the memory call at the queue's M; each the larger of operations
over the dtype's peak and bytes, each input read once and the output
written once, over 3.35 TB/s), over the device seconds of the kernels
that do it in the trace: the three-scale instantiation of the tiled
kernel, `xcorr_tile_kernel<T, 3>`."""
import re

from portbench.metrics import work

K1 = re.compile(r"xcorr_tile_kernel<[^>]*,\s*3>")


def read(ctx, out):
    if not out.trace or not out.counts.get("steps"):
        return None
    seconds = sum(v for k, v in out.trace["kernel_s"].items()
                  if K1.search(k))
    if seconds <= 0:
        return None
    cfg = ctx.config
    bf16 = cfg["dtype"] == "bfloat16"
    peak = work.PEAK_BF16 if bf16 else work.PEAK_F32
    calls = work.k1_calls(out.counts["lanes"], cfg["channels"],
                          cfg["tracker"]["mem_queue_size"], 2 if bf16 else 4)
    bound = sum(max(f / peak, b / work.PEAK_HBM) for f, b in calls)
    return 100.0 * bound * out.counts["steps"] / seconds
