"""The mining window's share of the card's float32 peak: one 3-frame
PWCLite forward at the configuration's test shape counted on the
reference (`work.flow_forward_flops`: its convolutions, cost volumes
and warps as the reference does them) times the forwards the window
ran, over the window's seconds times 67 TFLOP/s (float32 outside the
tensor cores, TF32 being off)."""
from portbench.metrics import work


def read(ctx, out):
    if not out.trace or not out.counts.get("forwards"):
        return None
    flops = work.flow_forward_flops(*ctx.config["test_shape"])
    return 100.0 * flops * out.counts["forwards"] / out.trace["window_s"] \
        / work.PEAK_F32
