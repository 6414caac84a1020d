"""The controls fail each cell's check, on the card (marked `gpu`; they
skip without one): the reference in the next precision down (fp8 for
the bf16 tracking cells, TF32 for the float32 training cell; the
mining program with TF32 on) and the training fault of half the batch,
at reduced lanes, frames and videos but the published widths (the
training cell at its own batch, where its control is read), on three
seeds each. The cell's sound run at the same size passes. Run:
`python3 -m pytest portbench/tests -m gpu`."""
import pytest
import torch

from conftest import ROOT, small_context
from portbench import controls, harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
WIDE = {"width": 64, "channels": 256}
REDUCED = {
    "track_b64_staged": dict(lanes=4, frames_per_video=33, chunk=8,
                             max_frames=40, check_lanes=2,
                             box_px=[48, 120], speed_px=[0.5, 2.0],
                             canvas=[480, 640]),
    "track_b1_live": dict(lengths=[40, 60], check_frames=60,
                          frame=[720, 1280], box_px=[80, 200],
                          speed_px=[0.5, 3.0]),
    "train_cycle_b12": dict(batch=12, mem_num=4),
    "mine_got10k_720p": dict(lengths=[60], frame=[720, 1280],
                             object_frac=[0.12, 0.3]),
}
CASES = [("track_b64_staged", "fp8"), ("track_b1_live", "fp8"),
         ("train_cycle_b12", "tf32"), ("train_cycle_b12", "half_batch"),
         ("mine_got10k_720p", "flow_tf32")]
# the mining cell's configuration as it stands: its published test shape
# and crop size (the CPU tests' small ones undone)
FULL = {"mine_got10k_720p": dict(test_shape=[384, 640], mining=dict(
    gap=3, init_adjacent=4, cut_ratio=0.03125, instance_size=511,
    max_frames=2000, quality_gate=False))}


def context(cell, seed, card):
    # float32 with TF32 off, as `harness.main` and `controls.main` set it
    # (PyTorch lets cuDNN use TF32 unless told not to)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return small_context(cell, seed=seed, seconds=1.0,
                         config={**WIDE, **FULL.get(cell, {})},
                         traffic=REDUCED[cell], device=card)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,variant", CASES)
def test_control_fails_the_check(cell, variant, card):
    for seed in SEEDS:
        bench, ctx = context(cell, seed, card)
        numbers = controls.run(ctx, variant)
        limits = ctx.config["limits"][ctx.traffic["driver"]]
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)


@pytest.mark.parametrize("cell", sorted(REDUCED))
def test_each_cell_names_a_control_it_can_run(cell):
    """The default control is the configuration's `control`, and the
    controls can put it in the program's place on the cell's driver."""
    _, _, config, traffic = harness.find_cell(ROOT, cell)
    variant = config["control"]
    assert variant in controls.PROGRAM \
        or traffic["driver"] in controls.REFERENCE[variant]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(REDUCED))
def test_sound_run_passes(cell, card):
    bench, ctx = context(cell, SEEDS[0], card)
    assert harness.run_cell(ctx, bench)["correct"]


@pytest.mark.gpu
def test_chunk_first_frame_fault_fails_the_check(card):
    """The fault on the first frame of each chunk alone (`faults.py`) at
    the published widths, one frame in 32: read at the cell's own size
    it fails `gap_max`; on the CPU's small widths it does not."""
    for seed in SEEDS:
        bench, ctx = small_context(
            "track_b64_staged", seed=seed, seconds=0.0, config=WIDE,
            traffic=dict(REDUCED["track_b64_staged"], frames_per_video=65,
                         chunk=32, max_frames=72), device=card)
        numbers = controls.run(ctx, "chunk_first_frame")
        limits = ctx.config["limits"]["engine_staged"]
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)
