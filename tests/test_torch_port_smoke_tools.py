"""`chip_smoke.py`'s phases 17 (the measuring entry points) and 18 (step
attribution and the lockstep benches) rehearsed on the CPU at the
fixture's widths, and their checks (batch vs scan gaps, roofline shares
and kernel calls per stage). Like
`test_torch_port_smoke.py`, this file imports no JAX (the fixture is read
by the port's own flax reader), so on a GPU machine it runs with
`--noconftest`."""
import os

import chip_smoke
import pytest
import torch

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_measuring_tools_run_at_small_width(tmp_path):
    """Phase 17 at w8c32 on the committed fixture (read without flax):
    the bench in bf16 and f32 with every leg (a forced 256-px ROI window
    on a 320x288 canvas), the protocol bench on 3 videos of 24-48 frames
    in both engines (the spill video spills; boxes on identical
    skeletons within the lockstep tolerance), the training bench at B=1
    in f32 and bf16."""
    from usot_tpu_torch.train.checkpoint import load_model_state

    weights = load_model_state(os.path.join(
        os.path.dirname(__file__), "fixtures", "tiny_usot_w8c32.msgpack"))
    rec, k1, train_launches = chip_smoke.run_measuring_tools(
        weights, CPU, sha256="fixture",
        bench_kw=dict(frames=17, chunk=8, batch=2, h=320, w=288, roi="256",
                      stream_chunk=4, repeats=1, width=8, channels=32),
        votbench_kw=dict(out_dir=str(tmp_path), videos=3, min_frames=24,
                         max_frames=48, h=120, w=160, chunk=8, batch=2,
                         width=8, channels=32),
        train_kw=dict(iters=1, extra=("--batch", "1", "--mem-batch", "1",
                                      "--mem-num", "2", "--width", "8",
                                      "--channels", "32")))
    assert k1 == {"bench": 0, "votbench": 0}
    assert train_launches == {"K1": 0, "K2": 0, "K3": 0}
    for dtype in ("bf16", "f32"):
        r = rec["bench"][dtype]
        assert set(r["legs"]) == chip_smoke.BENCH_LEGS
        assert r["legs"]["roi"]["roi_accepted"] == 2
        assert r["line"]["metric"] == \
            "usot_star_tracking_throughput_fps_per_chip"
        assert r["weights_sha256"] == "fixture"
    vot = rec["votbench"]
    assert vot["batch"]["spilled"] == ["spill"]
    assert vot["lockstep"]["early_frames"] > 0
    assert vot["lockstep"]["early_max_px"] <= chip_smoke.LOCKSTEP_TOL
    assert set(rec["bench_train"]) == {"float32", "bfloat16"}
    assert not any(tmp_path.iterdir())  # the protocol bench cleaned up


def test_lockstep_gaps_hold_the_first_steps_after_an_init():
    a = {"v": [1, [0.0] * 8, [0.0] * 8, [0.0] * 8, [0.0] * 8, 2, 0, 1,
               [0.0] * 8],
         "w": [1, [0.0] * 8, 2]}
    b = {"v": [1, [1e-3] * 8, [0.0] * 8, [0.0] * 8, [5.0] * 8, 2, 0, 1,
               [3e-3] * 8],
         "w": [1, 2, 0]}   # another skeleton: not compared
    gaps = chip_smoke.lockstep_gaps(a, b, steps=3)
    assert gaps == {"steps": 3, "early_max_px": 3e-3, "early_frames": 4,
                    "all_max_px": 5.0, "all_frames": 5}


def test_step_tools_run_at_small_width(tmp_path):
    """Phase 18 at w8c32 on the committed fixture: the microbench with its
    roofline table at B=2, the cliff sweep at B=2 and 3, the bisect A-F,
    memops and the lockstep benches at small sizes, every record written
    and digested by the battery (no device time on the CPU: "not
    measured"; the kernels' calls counted, none launched)."""
    from usot_tpu_torch.train.checkpoint import load_model_state

    weights = load_model_state(os.path.join(
        os.path.dirname(__file__), "fixtures", "tiny_usot_w8c32.msgpack"))
    rec, launches = chip_smoke.run_step_tools(
        weights, CPU, out_dir=str(tmp_path), width=8, channels=32,
        micro=("--batch", "2", "--iters", "1", "--max-frames", "48"),
        cliff_batches=(2, 3), cliff_stages="full,memhead,xcorr_pair,backbone",
        bisect=("--batch", "2", "--iters", "1"),
        memops=("--batch", "2", "--slots", "9", "--frames", "2",
                "--channels", "8"),
        lockstep=("--batch", "2", "--frames", "24", "--chunk", "8",
                  "--failures", "2", "--videos", "2", "--longs", "1",
                  "--reps", "1"), cliff_iters=1)
    none = {"K1": 0, "K2": 0, "K3": 0}
    assert launches == {"microbench": none, "cliff": none,
                        "lockstep_bench": none}
    assert sorted(os.listdir(tmp_path)) == [
        "bisect_b2.json", "cliff_b2.json", "cliff_b3.json", "lockstep.json",
        "memops.json", "mfu_inference.json", "step.json"]
    text = rec["battery"]
    assert "== 3: step attribution ==" in text and "B=3 full" in text
    assert "chain F" in text and "VOT staged median" in text
    # what the rehearsal does not run, and device times, are not measured
    assert text.count("not measured") > 20
    assert rec["lockstep"]["vot"]["reps"][0]["restarts"] == 2


def test_stage_checks_fail_on_a_share_above_the_bound():
    row = {"stage": "x", "device_ms": 1.0, "call_ms": 1.0, "share_pct": 101.0,
           "kernel_calls": {}, "launches": {"K1": 0, "K2": 0, "K3": 0}}
    cuda = torch.device("cuda")
    chip_smoke._stage_checks("t", [dict(row, share_pct=99.0)], cuda, {})
    with pytest.raises(RuntimeError, match="share"):
        chip_smoke._stage_checks("t", [row], cuda, {})
    with pytest.raises(RuntimeError, match="kernel calls"):
        chip_smoke._stage_checks("t", [dict(row, share_pct=5.0)], cuda,
                                 {"x": {"K1": 1}})
