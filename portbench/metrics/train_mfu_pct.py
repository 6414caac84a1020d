"""The cycle-memory training step's share of the card's peak over the
traced window: its forward and backward operations counted on the
reference (`work.train_step_flops`) times the steps run, over the
window's seconds times the peak of the configuration's compute dtype
(67 TFLOP/s float32 outside the tensor cores, TF32 being off)."""
from portbench.metrics import work


def read(ctx, out):
    if not out.trace or not out.counts.get("steps"):
        return None
    cfg, tr = ctx.config, ctx.traffic
    flops = work.train_step_flops(cfg["width"], cfg["channels"],
                                  tr["batch"], tr["mem_num"])
    peak = work.PEAK_BF16 if cfg["dtype"] == "bfloat16" else work.PEAK_F32
    return 100.0 * flops * out.counts["steps"] / out.trace["window_s"] / peak
