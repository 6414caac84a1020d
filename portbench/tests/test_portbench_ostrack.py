"""The OSTrack cell (`track_ostrack384_b64_staged`) on the CPU at a small
size: its driver end to end (untraced and traced lines), each planted
fault of `faults_ostrack.py` caught, the work counts against the
formula, and (marked `gpu`) the fp8 control failing the check at the
published widths."""
import math

import numpy as np
import pytest
import torch

from conftest import small_context
from portbench import controls_ostrack, faults_ostrack, harness
from portbench.metrics import work_ostrack
from portbench.reference import ostrack as ref

CELL = "track_ostrack384_b64_staged"
SIZES = dict(ref.SIZES, dim=64, heads=4, mlp=256, template=48, search=64,
             head_channels=32)
TRAFFIC = dict(lanes=3, canvas=[72, 96], frames_per_video=17, chunk=4,
               box_px=[12, 18], speed_px=[0.5, 1.0], check_lanes=3,
               trace_seconds=0.5)
NEW = {"ostrack_mfu_pct", "attn_roofline_pct.ostrack",
       "launches_per_step.ostrack", "host_step_ms.ostrack",
       "device_idle_pct.ostrack"}


# The fault tests' limits: the program in float32 on the CPU keeps the
# reference's CE sets exactly and reads ~1e-7 against the float32
# reference, so limits under the cell's (set for bf16's rounding at the
# published widths, PERF.md section 2: under one swap in twenty lane-frames,
# 1 % of `gap_mean`'s) hold the mechanism; the cell's own limits catch the
# faults at the published widths on the card (`controls_ostrack`,
# PERF.md).
F32_LIMITS = {"engine_staged_ostrack": {"swaps_mean": 0.05,
                                        "gap_mean": 1e-5,
                                        "ce_tokens_off": 0}}


def context(trace=False, dtype="bfloat16", **kw):
    config = {"sizes": SIZES, "dtype": dtype}
    if dtype == "float32":
        config["limits"] = F32_LIMITS
    return small_context(CELL, trace=trace, config=config,
                         traffic=dict(TRAFFIC, **kw))


def test_untraced_line():
    bench, ctx = context()
    line = harness.run_cell(ctx, bench)
    assert set(line["metrics"]) == {"track_fps", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] % (3 * 16) == 0 and line["failed"] == 0
    assert line["checks"]["ce_tokens_off"]["value"] == 0
    assert line["checks"]["swaps_mean"]["value"] >= 0


def test_traced_line():
    """The CPU trace has no device work: launches read 0, the idle share
    100, the attention roofline nothing; MFU and the host step read."""
    bench, ctx = context(trace=True)
    line = harness.run_cell(ctx, bench)
    _, layer = harness.cell_metrics(bench, CELL)
    assert {m["name"] for m in layer} == NEW
    assert set(line["metrics"]) == NEW - {"attn_roofline_pct.ostrack"}
    assert line["metrics"]["host_step_ms.ostrack"]["value"] > 0
    assert line["metrics"]["device_idle_pct.ostrack"]["value"] == 100.0


def readings(line):
    return {k: v["value"] for k, v in line["checks"].items()}


@pytest.mark.parametrize("fault", sorted(faults_ostrack.OSTRACK))
def test_fault_caught(fault, monkeypatch):
    """Sound at float32 reads at least ten times under the limit a fault
    breaks; the fault fails the check (float32 limits, `F32_LIMITS`)."""
    bench, ctx = context(dtype="float32")
    sound = harness.run_cell(ctx, bench)
    assert sound["correct"], readings(sound)
    with monkeypatch.context() as m:
        faults_ostrack.OSTRACK[fault](m)
        bench, ctx = context(dtype="float32")
        broken = harness.run_cell(ctx, bench)
    s, b = readings(sound), readings(broken)
    assert not broken["correct"], b
    assert any(b[k] > v["limit"] and b[k] >= 10 * max(s[k], 1e-12)
               for k, v in broken["checks"].items()), (s, b)


def test_controls_run_a_fault_and_sound():
    _, ctx = context(dtype="float32")
    sound = controls_ostrack.run(ctx, "sound")
    broken = controls_ostrack.run(ctx, "hann_dropped")
    limits = ctx.config["limits"]["engine_staged_ostrack"]
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(broken[k] > limits[k] for k in limits)


def test_step_flops_by_formula():
    """The reference's count at the published sizes: the blocks' linears
    at their token counts, attention's two products, the head, the
    search crop's patch embedding; two operations a multiply-add."""
    s = ref.SIZES
    lanes = 64
    got = work_ostrack.step_flops(work_ostrack.frozen(s), lanes)
    d, hid = s["dim"], s["mlp"]
    attn = work_ostrack.attention_tokens(s)
    assert attn == [720] * 4 + [548] * 3 + [427] * 3 + [343] * 2
    mlp = [720] * 3 + [548] * 3 + [427] * 3 + [343] * 3
    linears = sum(n * d * 4 * d for n in attn) + sum(n * d * 2 * hid
                                                     for n in mlp)
    cores = sum(2 * n * n * d for n in attn)
    head = 3 * 576 * 9 * (d * 256 + 256 * 128 + 128 * 64 + 64 * 32) \
        + 576 * 32 * 5
    embed = 576 * d * 3 * 16 * 16
    assert got == 2 * lanes * (linears + cores + head + embed)
    assert 6.8e12 < got < 7.0e12   # ~108 GFLOP a lane-frame


def test_attention_bound_by_block():
    """Per block the larger of FLOPs at the bf16 peak and bytes at
    3.35 TB/s: at 720 tokens the FLOPs bound it (4 N^2 C over 8 N C bytes
    is N / 2 operations a byte, over the card's ~295), at 548 and fewer
    the bytes."""
    s = ref.SIZES
    got = work_ostrack.attention_bound_s(work_ostrack.frozen(s), 64)
    want = 0.0
    for n in work_ostrack.attention_tokens(s):
        flops, nbytes = 4.0 * 64 * n * n * 768, 4.0 * 64 * n * 768 * 2
        assert (flops / 989e12 > nbytes / 3.35e12) == (n == 720)
        want += max(flops / 989e12, nbytes / 3.35e12)
    assert got == pytest.approx(want, rel=1e-12)


def test_kept_counts_as_published():
    assert ref.kept_counts(ref.SIZES) == [404, 283, 199]
    assert ref.centre_token(ref.SIZES) == 65
    assert ref.kept_counts(SIZES) == [12, 9, 7]
    assert ref.centre_token(SIZES) == 4
    assert math.ceil(0.7 * 576) == 404


@pytest.mark.gpu
def test_fp8_control_fails_the_check(card):
    """At the published widths on reduced lanes and frames, three seeds:
    the fp8 reference fails at least one of the cell's limits; the sound
    program at the same size passes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        bench, ctx = small_context(
            CELL, seed=seed, seconds=1.0, device=card,
            traffic=dict(lanes=4, frames_per_video=33, chunk=8,
                         check_lanes=2))
        numbers = controls_ostrack.run(ctx, "fp8")
        limits = ctx.config["limits"]["engine_staged_ostrack"]
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)
    assert harness.run_cell(ctx, bench)["correct"]
    assert np.isfinite(numbers["score_mean"])
