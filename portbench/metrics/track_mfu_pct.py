"""The tracking frame step's share of the card's peak over the traced
window: the step's operations counted on the reference
(`work.frame_step_flops` at the cell's lanes and queue) times the steps
run, over the window's seconds times the peak of the configuration's
compute dtype (989 TFLOP/s bf16 dense, 67 TFLOP/s float32)."""
from portbench.metrics import work


def read(ctx, out):
    if not out.trace or not out.counts.get("steps"):
        return None
    cfg = ctx.config
    flops = work.frame_step_flops(cfg["width"], cfg["channels"],
                                  out.counts["lanes"],
                                  cfg["tracker"]["mem_queue_size"],
                                  cfg["tracker"]["instance_size"])
    peak = work.PEAK_BF16 if cfg["dtype"] == "bfloat16" else work.PEAK_F32
    return 100.0 * flops * out.counts["steps"] / out.trace["window_s"] / peak
