"""The OSTrack frame step's share of the card's bf16 peak over the traced
window: the reference's count of one step at the cell's lanes
(`work_ostrack.step_flops`, the published kept-token counts, the
template's tokens carried) times the steps run, over the window's
seconds times 989 TFLOP/s (dense bf16)."""
from portbench.metrics import work_ostrack
from portbench.metrics.work import PEAK_BF16


def read(ctx, out):
    if not out.trace or not out.counts.get("steps"):
        return None
    flops = work_ostrack.step_flops(work_ostrack.frozen(ctx.config["sizes"]),
                                    out.counts["lanes"])
    return 100.0 * flops * out.counts["steps"] / out.trace["window_s"] \
        / PEAK_BF16
