"""`chip_smoke.py`'s checks rehearsed on the CPU at a small size, and the
kernels and the engine step on the card.

The script itself needs a GPU; its phases take the kernels and the
device as arguments, so here the plain versions stand in for the
kernels. This keeps the checks, the grouped-conv yardsticks' layouts,
the tools' stages and the slice's and engines' control flow tested where
there is no card. This file imports no JAX, so on a machine with a GPU
and without JAX it runs as
`python -m pytest --noconftest tests/test_torch_port_smoke.py`
(`tests/conftest.py` imports JAX); the tests marked `gpu` skip without a
card.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from usot_tpu_torch.ops.xcorr import (xcorr_depthwise_multi_reference,
                                      xcorr_depthwise_pairwise_reference,
                                      xcorr_groupdw_reference)

PLAIN = {"K2": xcorr_depthwise_multi_reference,
         "K3": xcorr_depthwise_pairwise_reference}

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_kernel_checks_pass_the_plain_version():
    records = chip_smoke.kernel_checks(xcorr_groupdw_reference,
                                       xcorr_groupdw_reference, CPU, c=16,
                                       timed=False)
    assert len(records) == 17
    assert [r["out"][1:4] for r in records[:4]] == [
        [1, 25, 25], [7, 25, 25], [1, 27, 27], [7, 27, 27]]
    # the batch engine's shapes in f32, then in bf16
    assert [r["out"][:2] for r in records[4:8]] == [[32, 1], [32, 7]] * 2
    assert [r["shape"].split(", ")[-1] for r in records[4:8]] \
        == ["f32"] * 2 + ["bf16"] * 2
    edges = [r["out"] for r in records if r["shape"].startswith("edge")]
    assert edges == [[2, 3, 25, 25, 40], [2, 3, 13, 16, 37],
                     [2, 3, 13, 16, 37], [2, 5, 27, 33, 64],
                     [4, 7, 13, 27, 16], [1, 1, 25, 33, 16],
                     [1, 2, 5, 40, 32]]
    assert all(r["max_abs_err"] <= r["tol"] for r in records)
    assert all(r["bound_by"] in ("bytes", "operations") for r in records)


def test_kernel_checks_catch_a_wrong_kernel():
    def off_by_one_tap(xs, ks):
        ks = [k.clone() for k in ks]
        ks[2][..., 0, 0, :] = 0.0
        return xcorr_groupdw_reference(xs, ks)

    with pytest.raises(RuntimeError, match="max \\|err\\|"):
        chip_smoke.kernel_checks(off_by_one_tap, xcorr_groupdw_reference,
                                 CPU, c=8, timed=False)


def test_library_yardstick_computes_the_same_function():
    xs, ks = chip_smoke.groupdw_inputs(np.random.default_rng(0), 2, 3, 5,
                                       9, 11, torch.float32, CPU)
    run, to_bmhwc = chip_smoke.groupdw_library(xs, ks)
    torch.testing.assert_close(to_bmhwc(run()),
                               xcorr_groupdw_reference(xs, ks),
                               atol=1e-4, rtol=0)


def test_bound_of_the_memory_head_launch():
    """B=1, M=7, C=256 at instance 255 in f32: ~7.34 MB at 3.35 TB/s."""
    xs, ks = chip_smoke.groupdw_inputs(np.random.default_rng(1), 1, 7, 256,
                                       29, 29, torch.float32, CPU)
    out = torch.empty(1, 7, 25, 25, 256)
    ms, by = chip_smoke.bound(xs, ks, out)
    assert by == "bytes" and ms == pytest.approx(2.1907e-3, rel=1e-3)


def test_single_checks_pass_the_plain_versions():
    records = chip_smoke.single_checks(PLAIN, PLAIN, CPU, c=8, timed=False)
    assert len(records) == 27
    tools = [r for r in records if r["x"][1:] == [29, 29, 8]]
    assert [(r["kernel"], r["out"][:2]) for r in tools] == [
        ("K3", [32, 25]), ("K3", [32, 25]), ("K3", [224, 25]),
        ("K3", [224, 25]), ("K2", [32, 7]), ("K2", [32, 7])]
    # the tiled kernels' edges: C=40, odd C, M=5, Ho 13/27, Wo 27/33/40,
    # B=1
    edges = [(r["kernel"], r["out"]) for r in records[16:]]
    assert edges == [
        ("K3", [2, 25, 25, 40]), ("K3", [2, 13, 16, 37]),
        ("K3", [2, 27, 33, 37]), ("K2", [2, 5, 25, 25, 40]),
        ("K2", [2, 5, 13, 16, 37]), ("K2", [2, 5, 27, 33, 37]),
        ("K3", [1, 13, 33, 8]), ("K2", [1, 7, 27, 27, 8]),
        ("K2", [1, 7, 13, 27, 8]), ("K3", [1, 7, 40, 32]),
        ("K2", [1, 3, 5, 40, 32])]
    assert all(r["max_abs_err"] <= r["tol"] for r in records)


def test_single_checks_catch_a_wrong_kernel():
    def skips_last_row(x, k):
        out = xcorr_depthwise_pairwise_reference(x, k).clone()
        out[:, -1] = 0
        return out

    with pytest.raises(RuntimeError, match="K3 kernel"):
        chip_smoke.single_checks({"K2": PLAIN["K2"], "K3": skips_last_row},
                                 PLAIN, CPU, c=8, timed=False)


def test_grouped_conv_yardstick_of_the_single_scale_kernels():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 9, 11, 5)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 3, 4, 3, 5))
                         .astype(np.float32))
    run, to_bmhwc = chip_smoke._grouped_conv(x, k)
    torch.testing.assert_close(to_bmhwc(run()),
                               xcorr_depthwise_multi_reference(x, k),
                               atol=1e-4, rtol=0)


def test_bound_of_the_tools_shapes():
    """K3 at B=32 in bf16 is bytes-bound (~24.4 MB); so is K2 at M=7 in
    bf16 (88.3 MB), its 1.79 GFLOP taking 1.8 us at the bf16 peak."""
    x = torch.empty(32, 29, 29, 256, dtype=torch.bfloat16)
    k3 = torch.empty(32, 5, 5, 256, dtype=torch.bfloat16)
    out3 = torch.empty(32, 25, 25, 256, dtype=torch.bfloat16)
    ms, by = chip_smoke.roofline([x, k3], out3, 25)
    assert by == "bytes" and ms == pytest.approx(7.292e-3, rel=1e-3)
    k2 = torch.empty(32, 7, 5, 5, 256, dtype=torch.bfloat16)
    out2 = torch.empty(32, 7, 25, 25, 256, dtype=torch.bfloat16)
    ms, by = chip_smoke.roofline([x, k2], out2, 25)
    assert by == "bytes" and ms == pytest.approx(2.6366e-2, rel=1e-3)
    # in f32: twice the bytes, still above the FP32 rate's 26.7 us
    ms, by = chip_smoke.roofline([x.float(), k2.float()], out2.float(), 25)
    assert by == "bytes" and ms == pytest.approx(5.2733e-2, rel=1e-3)


def test_ptxas_report_fails_on_spills():
    clean = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
             "ptxas info    : Function properties for _Z1kv\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
             "loads\n"
             "ptxas info    : Used 64 registers, used 1 barriers\n")
    report = chip_smoke.ptxas_report({"a.cu": (None, clean)})
    assert len(report["a.cu"]) == 3
    spilled = clean.replace("0 bytes spill stores", "8 bytes spill stores")
    with pytest.raises(RuntimeError, match="spills"):
        chip_smoke.ptxas_report({"a.cu": (None, spilled)})


def test_tools_stages_run_on_the_cpu():
    """Every stage of both benchmark tools runs at a tiny size; on CPU
    tensors the routes take the plain versions, so no kernel counts."""
    from usot_tpu_torch.tools import bench_memhead, bench_xcorr

    before = chip_smoke.launch_counts()
    for mod, n in ((bench_xcorr, 6), (bench_memhead, 10)):
        stages = mod.stages(2, torch.float32, CPU, channels=8)
        assert len(stages) == n
        for _, fn in stages:
            fn()
    assert chip_smoke.launch_counts() == before


def test_engines_run_at_small_width():
    model, _, _ = chip_smoke.run_slice(CPU, width=8, channels=32,
                                       n_frames=2, n_iter=1)
    rec, launches = chip_smoke.run_batch_engine(
        model, CPU, batch=3, n_frames=9, chunk=4, repeats=1, h=320, w=320,
        ragged_frames=5)
    assert launches == 0 and rec["frame_steps"] == 8
    assert rec["ragged_n_valid"] == [5, 4, 3]
    heads = rec["lane0_heads_gpu_vs_cpu"]
    assert set(heads) == {"search_features", "heads/cls", "heads/bbox",
                          "heads/cls_mem", "cls", "bbox_exponent",
                          "cls_mem", "bbox_exp"}
    assert all(set(r) == {"scaled_err", "max_abs_err", "scale"}
               | ({"overflow_differs"} if k != "bbox_exp" else set())
               for k, r in heads.items())
    rec, launches = chip_smoke.run_scan_engine(model, CPU, n_frames=9,
                                               chunk=4, h=320, w=320)
    assert launches == 0 and rec["frames"] == 8


def test_bf16_engine_runs_at_small_width():
    """Phase 11 at small width: the batch engine in bf16 on the f32
    model's weights, rings in bf16, lane 0 against the CPU, the f32
    phase's figures beside its own."""
    model, _, _ = chip_smoke.run_slice(CPU, width=8, channels=32,
                                       n_frames=2, n_iter=1)
    kw = dict(batch=2, n_frames=9, chunk=4, repeats=1, h=320, w=320,
              ragged_frames=5)
    f32_rec, _ = chip_smoke.run_batch_engine(model, CPU, **kw)
    rec, launches = chip_smoke.run_bf16_engine(model, CPU, f32_rec, **kw)
    assert launches == 0 and rec["frame_steps"] == 8
    assert rec["dtype"] == rec["ring_dtype"] == "torch.bfloat16"
    assert rec["lane0_tol"] == chip_smoke.BF16_LANE_TOL
    assert rec["f32_phase7"]["ms_per_step_median"] \
        == f32_rec["ms_per_step_median"]
    heads = rec["lane0_heads_gpu_vs_cpu"]
    assert set(heads) == {"search_features", "heads/cls",
                          "heads/bbox_exponent", "heads/cls_mem", "cls",
                          "bbox_exponent", "cls_mem", "bbox_exp"}
    assert all(heads[k]["scaled_err"] <= chip_smoke.BF16_LANE_TOL
               for k in heads if k.startswith(("search", "heads/")))
    bn = rec["bn_rounding"]
    assert bn["device"] == "cpu" and bn["cells"] == 4 * 64 * 9 * 9
    assert bn["flip_share"] <= chip_smoke.BN_FLIP_SHARE
    assert bn["max_ulps"] <= 1.0


def test_bn_rounding_check_catches_a_second_rounding(monkeypatch):
    """The BN check fails a BN that rounds its normalised input to bf16
    before the affine step (two roundings, not flax's one)."""
    from usot_tpu_torch.models import layers

    def rounds_twice(self, x, train=False):
        xf = x.float()
        norm = ((xf - self.running_mean[:, None, None])
                * torch.rsqrt(self.running_var + self.eps)[:, None, None])
        return norm.to(x.dtype) * self.weight[:, None, None].to(x.dtype) \
            + self.bias[:, None, None].to(x.dtype)

    monkeypatch.setattr(layers.BatchNorm, "forward", rounds_twice)
    with pytest.raises(RuntimeError, match="bf16 BN against flax"):
        chip_smoke.bn_rounding_check(CPU)


def test_fixture_tracks_in_both_dtypes():
    """The trained fixture through the port's msgpack reader, tracked in
    f32 and bf16; on the CPU the 'card' is the CPU, so its teacher-forced
    gaps are zero and the deviations between the dtypes are recorded."""
    rec = chip_smoke.run_fixture(CPU, n_frames=6)
    assert rec["frames"] == 5
    steps = rec["teacher_forced_step_max_gap"]
    assert steps["float32"]["pos"] == steps["bfloat16"]["pos"] == 0.0
    assert steps["bfloat16"]["own_pos"] > 0.0
    assert rec["deviation_px"]["card_f32_vs_bf16"]["max"] > 0.0
    assert all(np.isfinite(rec[f"center_error_vs_gt_cpu_{d}"])
               for d in ("float32", "bfloat16"))


def test_card_layer_ab_sides_compute_the_same():
    """`tools.ab_card_layers`' plain side computes what the layers' kept
    side does (bitwise on the CPU, where both take the same BN branch),
    for contiguous and channels-last bf16 input, and `use("kept")` puts
    the layers' own forwards back."""
    from usot_tpu_torch.models import layers
    from usot_tpu_torch.tools import ab_card_layers as ab

    torch.manual_seed(0)
    block = layers.ConvBN(16, 8, 3, padding=1, bias=True, relu=True).eval()
    x = torch.randn(2, 16, 9, 9).to(torch.bfloat16)
    try:
        with torch.no_grad():
            for layout in (torch.contiguous_format, torch.channels_last):
                xi = x.contiguous(memory_format=layout)
                ab.use("kept")
                kept = block(xi)
                ab.use("plain")
                plain = block(xi)
                torch.testing.assert_close(plain, kept, rtol=0, atol=0)
    finally:
        ab.use("kept")
    assert layers.BatchNorm.forward is ab.KEPT["bn"]
    assert layers.Conv2d.forward is ab.KEPT["conv"]


@pytest.mark.parametrize("data", ["crop511", "shards"])
def test_measure_bf16_drift_runs_at_small_width(tmp_path, data):
    """`tools.measure_bf16_drift` end to end at w8c32 on the CPU, on
    `tools/train_synthetic.py`'s dataset through the live loader (the
    default) or on the synthetic shard set: JAX's 7-epoch synthetic
    schedule cut to one batch per epoch, the saved state dict, and both
    dtypes' trajectories with their deviations."""
    from usot_tpu_torch.tools import measure_bf16_drift

    rec = measure_bf16_drift.main([
        "--device", "cpu", "--width", "8", "--channels", "32", "--samples",
        "8", "--frames", "10", "--out", str(tmp_path / "out"), "--json",
        str(tmp_path / "drift.json"), "--data", data])
    assert rec["recipe"]["data"] == data
    assert rec["frames_tracked"] == 9
    assert sorted(rec["loss_avg"]) == [str(e) for e in range(1, 8)]
    assert all(np.isfinite(v) for v in rec["loss_avg"].values())
    state = torch.load(rec["checkpoint"], weights_only=True)
    assert all(t.dtype in (torch.float32, torch.int64)
               for t in state.values())
    for key in ("center_deviation_px", "size_deviation_px",
                "score_deviation", "center_error_vs_gt_f32",
                "center_error_vs_gt_bf16"):
        assert set(rec[key]) == {"mean", "p95", "max"}, key
        assert np.isfinite(rec[key]["max"]), key
    assert (tmp_path / "drift.json").read_text().startswith('{"bf16_drift"')
    assert not [d for d in os.listdir(tmp_path / "out")
                if d.startswith("tmp")]  # the data are removed


def test_protocols_run_at_small_width(tmp_path):
    """Phase 9 at 320x320 (ROI on 448x512) and small batches: the VOT
    group restarts in its first chunk (a replay), re-inits across a
    chunk and spills one video, its rows equal the scan path's; refill
    covers every video; the splice and donate=False checks hold bitwise;
    ROI chunks agree with full frames."""
    model = chip_smoke.build_model(CPU, width=8, channels=32, n_iter=1)
    rec, launches = chip_smoke.run_protocols(
        model, CPU, h=320, w=320, box=48, vot_lanes=3, vot_lengths=(20, 24),
        chunk=8, refill_lanes=2, refill_lengths=(3, 12), refill_videos=4,
        roi_lanes=2, roi_frames=8, roi_hw=(448, 512),
        out_dir=str(tmp_path))
    assert launches == 0 and rec["k1_launches"] == {
        "vot": 0, "refill": 0, "roi": 0, "total": 0}
    vot = rec["vot"]
    assert vot["videos"] == 3 and len(vot["spilled"]) == 1
    assert vot["replays"] >= 1
    assert vot["skeletons"]["vot0"].startswith("1200001b")
    assert vot["skeletons"]["vot1"][:10] == "1bbb200001"
    assert vot["skeletons"]["vot2"][12:18] == "200001"
    assert rec["refill"]["refills"] == 2 and rec["refill"]["videos"] == 4
    roi = rec["roi"]
    assert roi["max_abs_err_px"] <= 1e-2 and roi["roi_chunks"] >= 1
    assert roi["suggested_roi"] < 448 and not roi["roi_fallback"]
    assert roi["roi_accepted"] > roi["roi_replays"]
    one = roi["one_frame_chunks"]
    assert one["max_abs_err_px"] <= 1e-2 and one["roi_accepted"] >= 1
    assert rec["donate"]["ring_copy_ms_b8_2048"] is None
    assert rec["donate"]["ring_bytes_per_lane_at_2048"] \
        == 2049 * 55 * 32 * 4


def _check_training_record(rec, launches):
    assert launches == {"K1": 0, "K2": 0, "K3": 0}
    assert sorted(rec["losses"]) == [str(e) for e in range(1, 7)]
    assert all(len(v) == 2 for v in rec["losses"].values())
    assert rec["resume_max_rel_loss_delta"] <= 1e-3
    assert set(rec["gpu_vs_cpu"]) == {
        "naive_frozen", "cycle_frozen", "naive_unfrozen_f64",
        "naive_unfrozen_f32_vs_cpu_f64"}
    assert set(rec["steps"]) == {
        "naive_frozen", "naive_unfrozen", "cycle_frozen", "cycle_unfrozen",
        "cycle_unfrozen_remat", "cycle_unfrozen_accum2"}
    assert all(r["ms_per_step"] > 0 and r["samples_per_s"] > 0
               for r in rec["steps"].values())


def test_training_runs_at_small_width(tmp_path):
    """Phase 10 at w8c32, B=2, 2 memory frames on the CPU: the 6-epoch
    staged schedule through the trainer's function on a synthetic shard
    set, its resume (exact on the CPU), the step against the CPU (the
    same device in this rehearsal: exact, but for the float32 step held
    against the float64 one) and the timed programs; no kernel
    launched."""
    rec, launches = chip_smoke.run_training(
        CPU, width=8, channels=32, batch=2, mem=2, iters=2, timing_steps=1,
        out_dir=str(tmp_path))
    _check_training_record(rec, launches)
    assert rec["resume_max_rel_loss_delta"] == 0.0
    held = ("naive_frozen", "cycle_frozen", "naive_unfrozen_f64")
    assert all(rec["gpu_vs_cpu"][k]["max_scaled_grad_err"]["err"] == 0.0
               for k in held)


def _check_bf16_training_record(rec, launches):
    assert launches == {"K1": 0, "K2": 0, "K3": 0}
    assert rec["dtype"] == "bfloat16"
    assert sorted(rec["losses"]) == [str(e) for e in range(1, 7)]
    assert all(len(v) == 2 for v in rec["losses"].values())
    assert rec["resume_max_rel_loss_delta"] <= 1e-2
    assert set(rec["gpu_vs_cpu"]) == {"naive_frozen", "cycle_frozen",
                                      "naive_unfrozen"}
    stages = {"connect_model", "neck"}
    for k, r in rec["gpu_vs_cpu"].items():
        assert ("loss_terms" in r) == k.startswith("naive"), k
        assert set(r["grad_cosine_to_cpu_f32"]) == stages | (
            {f"features.features.layer{i}" for i in (1, 2, 3)}
            if k.endswith("unfrozen") else set()), k
    assert set(rec["steps"]) == {"naive_frozen", "naive_unfrozen",
                                 "cycle_frozen", "cycle_unfrozen"}
    assert all(r["samples_per_s"] > 0 and "f32_ms_per_step" in r
               for r in rec["steps"].values())
    assert set(rec["live_loader"]) == {
        "naive_workers_1", "naive_workers_2", "cycle_workers_1",
        "cycle_workers_2"}
    assert all(r["samples_per_s"] > 0 and r["first_batch_s"] > 0
               for r in rec["live_loader"].values())
    assert rec["pipelined"]["ms_per_step"] > 0


def test_training_bf16_runs_at_small_width(tmp_path):
    """Phase 12 at w8c32, B=2, 2 memory frames on the CPU: the trainer
    with no shard set in bf16 from the live loader over three in-memory
    videos of `tools/train_synthetic.py`'s dataset, 2 threads; its
    resume (exact on the CPU), the step against the CPU (the same device
    here: gaps 0), the timed programs beside phase 10's, the loader's
    rates alone and pipelined; no kernel launched."""
    f32 = {k: {"ms_per_step": 1.0, "peak_bytes": None}
           for k in ("naive_frozen", "naive_unfrozen", "cycle_frozen",
                     "cycle_unfrozen")}
    rec, launches = chip_smoke.run_training_bf16(
        CPU, width=8, channels=32, batch=2, mem=2, iters=2, workers=2,
        timing_steps=1, f32_steps=f32, n_videos=3, pipe_steps=2,
        out_dir=str(tmp_path))
    _check_bf16_training_record(rec, launches)
    assert rec["resume_max_rel_loss_delta"] == 0.0
    for r in rec["gpu_vs_cpu"].values():
        assert r["grads"]["card_vs_cpu_bf16"] == 0.0
        assert all(c["card_bf16"] == c["cpu_bf16"] > 0.0
                   for c in r["grad_cosine_to_cpu_f32"].values())
    assert not os.listdir(tmp_path)  # the data and checkpoints are removed


@pytest.mark.parametrize("fault", ["zero", "sign"])
def test_bf16_training_check_catches_a_wrong_gradient(monkeypatch, fault):
    """Phase 12's card-against-CPU check fails when the "card"'s bf16
    gradients (the CPU here) are zeroed or sign-flipped, which its gap
    limits alone would pass in the unfrozen phase."""
    from usot_tpu_torch.models.usot import build_usot, init_model

    calls = []
    grads_and_stats = chip_smoke._grads_and_stats

    def wrong_on_the_card(model):
        grads, stats = grads_and_stats(model)
        calls.append(None)
        if len(calls) % 3 == 1:  # the card's program runs first
            k = 0.0 if fault == "zero" else -1.0
            grads = {n: k * g for n, g in grads.items()}
        return grads, stats

    monkeypatch.setattr(chip_smoke, "_grads_and_stats", wrong_on_the_card)
    kw = {"mem_size": 2, "width": 8, "channels": 32}
    model = build_usot(**kw)
    init_model(model, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(RuntimeError, match="direction"):
        chip_smoke.bf16_training_vs_cpu(kw, model.state_dict(), CPU,
                                        loss_samples=2)


def test_training_sample_labels_its_box():
    """`training_sample`: the label disk, the regression targets and the
    pool box describe the square drawn in the search image."""
    sample = chip_smoke.training_sample(np.random.default_rng(0), True,
                                        mem=3)
    assert sample["search_memory"].shape == (3, 255, 255, 3)
    # the box back from the search feature axis (cells 8 px from x=31)
    x1, y1, x2, y2 = sample["search_bbox"] / 0.125 + 31
    assert x2 - x1 == y2 - y1 == 64
    inner = sample["search"][int(y1) + 8:int(y2) - 8,
                             int(x1) + 8:int(x2) - 8].reshape(-1, 3)
    assert np.all(np.abs(inner.mean(0) - [200, 180, 60]) < 10)
    # 7 or 8 grid points per axis fall strictly inside a 64-px box
    w = sample["reg_weight"]
    rows, cols = np.nonzero(w)
    assert w.sum() in (49, 56, 64)
    assert np.all(sample["reg_target"][w == 1] > 0)
    assert np.all(sample["reg_target"][w == 0].min(-1) <= 0)
    centre = (np.array([(y1 + y2) / 2, (x1 + x2) / 2]) - 127) / 8 + 12
    assert np.all(np.abs(np.argwhere(sample["label"] == 1).mean(0)
                         - centre) <= 1)
    assert sample["label"].sum() == 13  # the L1 disk of radius 2


def test_slice_runs_at_small_width():
    model, results, launches = chip_smoke.run_slice(
        CPU, width=8, channels=32, n_frames=3, n_iter=1)
    assert launches == 0  # CPU tensors never reach the kernel
    assert [r["frames_tracked"] for r, _ in results] == [2, 2]
    errs = chip_smoke.parity_vs_cpu(model, results, CPU)
    assert set(errs) == {"search_features", "cls", "bbox", "cls_mem"}


def _check_mining_record(rec, launches, n_frames):
    assert launches == {"K1": 0, "K2": 0, "K3": 0}
    assert rec["sampled_frames"] == len(range(3, n_frames - 3, 3))
    assert rec["forwards"] >= rec["sampled_frames"]
    assert set(rec["host_ms_per_frame"]) == {
        "preprocess", "flow_to_bbox", "smooth_bbox_dp", "crop"}
    sec = rec["seconds_per_video"]
    assert sec["total"] == pytest.approx(
        sec["mine"] + sec["crop"] + sec["train_json"])
    assert sec["flow_loop"] > 0 and rec["frames_mined_per_s"] > 0
    vs = rec["gpu_vs_cpu"]
    assert len(vs["decisions"]) == rec["forwards"]
    assert len(vs["boxes"]) == rec["sampled_frames"]
    assert vs["max_scaled_err"] <= 1e-3
    return vs


def test_pseudo_labels_run_at_small_size():
    """Phase 13 at 96x128, test shape 64x96, 14 frames on the CPU: the
    mining path through the CLI's functions, crops and train.json, the
    loop held against the CPU (the same device here: every gap 0, every
    decision and box held equal); no kernel launched."""
    rec, launches = chip_smoke.run_pseudo_labels(
        CPU, n_frames=14, h=96, w=128, test_shape=(64, 96))
    vs = _check_mining_record(rec, launches, 14)
    assert vs["max_flow_gap_px"] == 0.0
    assert vs["decisions_held"] == rec["forwards"]
    assert all(b["held_equal"] and b["reproduces_run"] for b in vs["boxes"])
    gf = rec["conv_gflop_per_forward"]
    assert gf["total"] == pytest.approx(sum(
        v for k, v in gf.items() if k != "total"))
    assert "forward" not in rec  # device times only on the card


def test_mining_checks_catch_a_wrong_flow():
    """The card-against-CPU check fails a flow off by more than 1e-3."""
    from usot_tpu_torch.preprocessing import inference

    frames = chip_smoke.mining_video(8, 96, 128)
    card = inference.FlowHelper(test_shape=(64, 96), device="cpu")
    cpu = inference.FlowHelper(card.model.state_dict(), test_shape=(64, 96),
                               device="cpu")
    with torch.no_grad():
        cpu.model.context_networks.convs[6][0].bias.add_(0.05)
    with pytest.raises(RuntimeError, match="flow card vs CPU"):
        chip_smoke.mining_vs_cpu(card, cpu, frames, [(3, 4, 0.1)], [[]])


def test_png_bytes_decode_to_the_frame(tmp_path):
    """Phase 14's PNG writer (zlib, no image library): a decoder reads
    back the frame and `_image_size` its size."""
    Image = pytest.importorskip("PIL.Image")  # a decoder of its own
    from usot_tpu_torch.eval.datasets import _image_size

    rng = np.random.default_rng(0)
    frame = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(chip_smoke.png_bytes(frame))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im)[..., ::-1], frame)
    assert _image_size(str(path)) == (53, 37)
    store = chip_smoke.FrameStore()
    store.write(str(tmp_path / "a" / "b.png"), frame)
    store.write(str(tmp_path / "c.x.jpg"), frame[:4])
    assert (tmp_path / "a" / "b.png").exists()
    assert not (tmp_path / "c.x.jpg").exists()  # held in memory only
    assert store.read(tmp_path / "a" / "b.png") is frame
    assert store.read(str(tmp_path / "none.png")) is None


def test_trax_runs_at_small_width():
    """Phase 14a at w8c32 on small frames: both sessions through the
    pipes, regions equal to the direct tracker's."""
    rec, launches = chip_smoke.run_trax(CPU, width=8, channels=32,
                                        n_frames=6, rect_hw=(240, 320),
                                        mask_hw=(256, 384))
    assert launches == 0
    for fmt in ("rectangle", "mask"):
        r = rec[fmt]
        assert r["max_abs_px_vs_direct"] <= 1e-3
        assert r["max_abs_confidence_vs_direct"] <= 1e-5
        assert r["ms_per_frame_median"] > 0
    assert rec["mask"]["rle_encode_ms_median"] > 0


def _write_vot_results(root, vot, fail_at):
    """Restart-protocol result files of `vot`'s videos (boxes from the
    ground truth, a failure at `fail_at[v]`); returns the skeletons."""
    skeletons = {}
    for v, video in vot.items():
        rows, f, gt = [], 0, video["gt"]
        while f < len(gt):
            rows.append("1")
            f += 1
            while f < len(gt):
                if f == fail_at.get(v):
                    rows += ["2"] + ["0"] * min(4, len(gt) - f - 1)
                    f += 5
                    break
                rows.append(",".join(repr(float(x)) for x in gt[f]))
                f += 1
        rows = rows[:len(gt)]
        d = os.path.join(root, "batch", "VOT2018", "USOT", "baseline", v)
        os.makedirs(d)
        with open(os.path.join(d, v + "_001.txt"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
        skeletons[v] = "".join("b" if "," in r else r for r in rows)
    return skeletons


def test_evaluate_scores_protocol_results(tmp_path):
    """Phase 14b on result files laid out as phase 9 writes them: every
    video scored, failures equal to the restarts, finite numbers; a
    skeleton that disagrees fails the check."""
    kw = dict(h=96, w=128, box=16, vot_lanes=3, vot_lengths=(48, 52),
              chunk=8, refill_lengths=(3, 12), refill_videos=3)
    vot, refill = chip_smoke.protocol_datasets(**kw)
    root = str(tmp_path)
    skeletons = _write_vot_results(root, vot, {"vot0": 20, "vot2": 31})
    for v, video in refill.items():
        d = os.path.join(root, "refill", "OTB2015", "USOT")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, v + ".txt"), "w") as fh:
            fh.write("".join(",".join(str(x) for x in g + [1, 1, 0, 0])
                             + "\n" for g in video["gt"]))
    proto = {"vot": {"skeletons": skeletons}}
    rec = chip_smoke.score_protocols(root, proto, vot, refill)
    assert rec["failures"] == {"vot0": 1, "vot1": 0, "vot2": 1}
    assert rec["vot_videos"] == 3 and rec["otb_videos"] == 3
    assert rec["auc"] > 0.9 and rec["accuracy"] > 0.9
    assert np.isfinite(rec["eao_vot2019_window"])
    assert os.path.exists(os.path.join(root, "VOT2019.json"))
    proto["vot"]["skeletons"]["vot1"] = "12"
    with pytest.raises(RuntimeError, match="phase 9's restarts"):
        chip_smoke.score_protocols(root, proto, vot, refill)


def test_onekey_runs_in_process_at_small_width(monkeypatch):
    """Phase 14c at w8c32: mine, train two epochs, test both checkpoints,
    evaluate, all in this process with the frames in memory."""
    from usot_tpu_torch.cli import parse_flow
    from usot_tpu_torch.preprocessing import inference

    monkeypatch.setattr(parse_flow, "FlowHelper", lambda device=None:
                        inference.FlowHelper(test_shape=(64, 96),
                                             device=device))
    rec, launches = chip_smoke.run_onekey(
        CPU, n_frames=12, raw_hw=(96, 128), bench_hw=(192, 224),
        bench_frames=6, batch=2, mem=2, iters=1, width=8, channels=32)
    assert launches == 0
    assert list(rec["stage_times"]) == ["preprocess", "train",
                                        "test_epochs", "evaluate"]
    assert rec["tested_frames"] == 2 * 2 * 5
    assert all(np.isfinite(a) for a in rec["auc"].values())


def test_sharded_engine_runs_at_small_width():
    """Phase 15a at w8c32 on the CPU: two shards on one device against
    the unsharded engine (the same device: every gap 0), the warm chunk,
    the timed runs, the splice across the boundary and the fixture."""
    model, _, _ = chip_smoke.run_slice(CPU, width=8, channels=32,
                                       n_frames=2, n_iter=1)
    kw = dict(batch=4, n_frames=17, chunk=8, repeats=1, h=320, w=320,
              ragged_frames=5)
    f32_rec, _ = chip_smoke.run_batch_engine(model, CPU, **kw)
    bf16_rec, _ = chip_smoke.run_bf16_engine(model, CPU, f32_rec, **kw)
    rec, launches = chip_smoke.run_sharded_engine(
        model, CPU, f32_rec, bf16_rec, batch=4, n_frames=17, chunk=8,
        forced=3, repeats=1, h=320, w=320)
    assert launches == 0 and rec["shards"] == 2
    for label in ("float32", "bfloat16"):
        r = rec[label]
        assert r["frame_steps"] == 16
        gaps = r["teacher_forced_gap"]
        assert all(gaps[k]["max"] == 0.0
                   for k in ("pos", "sz", "score", "mem_conf"))
        assert gaps.get("argmax_agrees_share", 1.0) == 1.0
        splice = r["splice_across_boundary"]
        assert splice["lanes"] == [1, 2] and splice["carry_equal"]
        assert r["free_running_nonfinite_lanes"] == 0
        assert r["unsharded"]["ms_per_step_median"] \
            == (f32_rec if label == "float32"
                else bf16_rec)["ms_per_step_median"]
    assert rec["fixture"]["sharded_vs_unsharded_px_float32"] <= 2e-3
    assert rec["fixture"]["sharded_vs_unsharded_px_bfloat16"] <= 2e-3
    assert rec["bfloat16"]["teacher_forced_gap"]["score"]["held"]


def test_sharded_engine_check_catches_a_wrong_shard(monkeypatch):
    """The teacher-forced check fails a sharded engine whose second
    shard tracks from a shifted carry."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    model, _, _ = chip_smoke.run_slice(CPU, width=8, channels=32,
                                       n_frames=2, n_iter=1)
    plain_scatter = BatchScanEngine.scatter_state

    def shifted(self, state):
        out = plain_scatter(self, state)
        last = out.shards[-1]
        shards = out.shards[:-1] + (last._replace(pos=last.pos + 3.0),)
        return type(out)(shards)

    monkeypatch.setattr(BatchScanEngine, "scatter_state", shifted)
    rec = {"ms_per_step_median": 1.0, "fps_median": 1.0,
           "k1_launches_per_step": 0.0}
    with pytest.raises(RuntimeError, match="sharded engine float32"):
        chip_smoke.run_sharded_engine(model, CPU, rec, rec, batch=4,
                                      n_frames=17, chunk=8, forced=2,
                                      repeats=1, h=320, w=320)


def test_sharded_engine_check_catches_wrong_bf16_scores(monkeypatch):
    """The bf16 hold fails a sharded engine whose shards report scores
    0.1 off in bf16 alone (the f32 pass and the argmax unchanged)."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    model, _, _ = chip_smoke.run_slice(CPU, width=8, channels=32,
                                       n_frames=2, n_iter=1)
    plain_chunk = BatchScanEngine._chunk

    def off(self, *args):
        carry, (pos, sz, score) = plain_chunk(self, *args)
        if self.dtype == torch.bfloat16 and self.batch == 2:  # a shard
            score = score + 0.1
        return carry, (pos, sz, score)

    monkeypatch.setattr(BatchScanEngine, "_chunk", off)
    rec = {"ms_per_step_median": 1.0, "fps_median": 1.0,
           "k1_launches_per_step": 0.0}
    with pytest.raises(RuntimeError, match="sharded engine bfloat16 .*"
                                           "score"):
        chip_smoke.run_sharded_engine(model, CPU, rec, rec, batch=4,
                                      n_frames=17, chunk=8, forced=2,
                                      repeats=1, h=320, w=320)


def test_data_parallel_training_runs_at_small_width(tmp_path):
    """Phase 15b at w8c32, B=2 per rank, 2 memory frames: two gloo ranks
    on the CPU against one process with the global batch, every case
    held, per-rank BN statistics far off; phase 15c: a gloo group of one
    through the trainer, and the dry run."""
    rec, launches = chip_smoke.run_data_parallel_training(
        CPU, width=8, channels=32, batch=2, mem=2, out_dir=str(tmp_path))
    assert launches == {"K1": 0, "K2": 0, "K3": 0}
    assert rec["launches_ranks"] == launches
    assert set(rec["cases"]) == {"naive_frozen", "cycle_frozen",
                                 "cycle_unfrozen", "cycle_frozen_accum2"}
    assert rec["global_batch"] == 4
    assert rec["bn_sync_off_stat_scaled_err"] > 1e-3
    assert all(len(r["ms_per_step_rank"]) == 2 and
               r["ms_per_step_rank"][0] > 0 for r in rec["cases"].values())
    rec = chip_smoke.run_nccl_and_dryrun(CPU, width=8, channels=32,
                                         batch=2, mem=2,
                                         out_dir=str(tmp_path))
    assert rec["backend"] == "gloo" and len(rec["losses"]) == 2
    assert np.isfinite(rec["dryrun_loss"])


def test_trained_weights_run_at_small_width(tmp_path, monkeypatch):
    """Phase 16 at w8c32: the full-schedule tool's three children (the
    30-epoch schedule, one step of B=2 per epoch, the kill in epoch 16),
    the accuracy runs on its last checkpoint, the batch engine at two
    batches in f32 and bf16 and the ROI leg on the trained weights. The
    accuracy and bf16 limits are the card's at full width: a model of 8
    channels after 30 steps tracks loosely and may not beat random
    weights, so here any gap passes; `test_trained_accuracy_check_*` and
    `test_trained_bf16_steps_*` hold the checks."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rec, launches = chip_smoke.run_trained_weights(
        CPU, width=8, channels=32,
        schedule_kw=dict(batch=2, samples=2, videos=2),
        accuracy_kw=dict(videos=2, frames=10, f32_tol=1.0, min_gain=-1.0),
        bf16_kw=dict(videos=2, frames=10, tol=1.0, min_agree=0.0),
        engine_kw=dict(batches=(2, 3), n_frames=9, chunk=4, h=320, w=320),
        roi_kw=dict(lanes=2, n_frames=8, hw=(448, 512), box=48, chunk=8),
        out_dir=str(tmp_path))
    assert launches == 0 and rec["k1_launches"]["total"] == 0
    sched = rec["schedule"]
    assert sched["interrupted_prefix_max_delta"] == 0.0
    assert sched["resume_max_loss_delta"] == 0.0
    assert sorted(map(int, sched["loss_avg"])) == list(range(1, 31))
    assert set(sched["unbroken_steps"]["ms_per_step"]) == {
        "naive", "cycle_frozen", "cycle_unfrozen"}
    acc = rec["accuracy"]
    assert set(acc) >= {"USOT_parity", "USOT_batch_f32", "USOT_batch_bf16",
                        "USOT_random", "delta_USOT_batch_f32",
                        "delta_USOT_batch_bf16", "jax"}
    assert rec["bf16_steps"]["steps"] == 9 and rec["bf16_steps"]["lanes"] == 2
    assert set(rec["engine"]) == {"B=2 f32", "B=3 f32", "B=2 bf16",
                                  "B=3 bf16"}
    assert all(r["finite_every_lane_and_step"]
               for r in rec["engine"].values())
    assert rec["roi"]["max_abs_err_px"] <= 1e-2
    assert rec["roi"]["one_frame_chunks"]["roi_accepted"] >= 1


@pytest.mark.parametrize("gap", ["f32_auc", "untrained"])
def test_trained_accuracy_check_catches_a_gap(monkeypatch, gap):
    """Phase 16b fails on a batch engine 0.006 AUC off in f32 (limit
    0.005) or on trained weights no better than random ones."""
    from usot_tpu_torch.tools import accuracy_parity_run as acc

    f32 = {"auc": 0.006 if gap == "f32_auc" else 0.0, "precision20": 0.0}
    ops = {"auc": 0.5, "precision20": 0.9}
    rand = {"auc": 0.6 if gap == "untrained" else 0.1, "precision20": 0.1}
    monkeypatch.setattr(acc, "run", lambda args: {
        "USOT_parity": ops, "USOT_random": rand,
        "delta_USOT_batch_f32": f32, "delta_USOT_batch_bf16": f32})
    with pytest.raises(RuntimeError, match="parity vs batch|random"):
        chip_smoke.trained_accuracy(CPU, "ckpt.pth", "out")


def _fixture_model():
    """The committed trained fixture, read without flax."""
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.train.checkpoint import load_model_state
    from usot_tpu_torch.utils.msgpack import read_msgpack

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "tiny_usot_w8c32.msgpack")
    meta = read_msgpack(path)
    model = build_usot(mem_size=int(meta["mem_size"]),
                       width=int(meta["width"]),
                       channels=int(meta["channels"]), fused_xcorr=True)
    model.load_state_dict(load_model_state(path))
    return model.eval()


def test_trained_bf16_steps_hold_on_the_trained_fixture(tmp_path):
    """Phase 16b's bf16 check at the card's limits on the committed
    trained fixture (w8c32) over the accuracy benchmark's 6 videos."""
    rec, launches = chip_smoke.trained_bf16_steps(
        _fixture_model(), CPU, str(tmp_path), frames=12)
    assert launches == 0 and rec["steps"] == 11 and rec["lanes"] == 6
    assert rec["argmax_agrees_share"] >= 0.5
    assert rec["score"]["share_over_tol_agreeing"] == 0.0


def test_trained_bf16_steps_catch_wrong_scores(monkeypatch, tmp_path):
    """The bf16 hold fails a bf16 engine whose scores are 0.1 off (the
    argmax unchanged)."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    plain_chunk = BatchScanEngine._chunk

    def off(self, *args):
        carry, (pos, sz, score) = plain_chunk(self, *args)
        if self.dtype == torch.bfloat16:
            score = score + 0.1
        return carry, (pos, sz, score)

    monkeypatch.setattr(BatchScanEngine, "_chunk", off)
    with pytest.raises(RuntimeError, match="trained batch engine bf16 "
                                           "against float32: score"):
        chip_smoke.trained_bf16_steps(_fixture_model(), CPU, str(tmp_path),
                                      videos=2, frames=4)


def test_entry_runs_on_the_cpu():
    rec, launches = chip_smoke.run_entry(CPU)
    assert launches == 0 and rec["shapes"][3] == [1, 31, 31, 256]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_groupdw_kernel_on_gpu():
    """The CUDA kernel against its plain version on the card: f32 at the
    production shapes and a ragged one (1e-4 scale-aware, the Pallas
    kernel's tolerance), with one launch counted per call."""
    _cuda()
    from usot_tpu_torch.ops.xcorr_kernel import xcorr_groupdw_cuda

    cuda = torch.device("cuda")
    records = chip_smoke.kernel_checks(xcorr_groupdw_cuda,
                                       xcorr_groupdw_reference, cuda,
                                       timed=False)
    assert all(r["max_abs_err"] <= r["tol"] for r in records)
    xs, ks = chip_smoke.groupdw_inputs(np.random.default_rng(2), 2, 3, 40,
                                       8, 9, torch.float32, cuda)
    before = xcorr_groupdw_cuda.launches
    out = xcorr_groupdw_cuda(xs, ks)
    assert xcorr_groupdw_cuda.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        xcorr_groupdw_cuda([x.transpose(1, 2) for x in xs], ks)
    torch.testing.assert_close(out, xcorr_groupdw_reference(xs, ks),
                               atol=1e-4 * max(float(out.abs().max()), 1.0),
                               rtol=0)


@pytest.mark.gpu
def test_single_scale_kernels_on_gpu():
    """K2 and K3 against their plain versions on the card (f32 1e-4
    scale-aware, bf16 2^-7 of the largest output), one launch counted per
    call, and no input they do not take."""
    cuda = _cuda()
    from usot_tpu_torch.ops import xcorr_kernel as xk

    kernels = {"K2": xk.xcorr_depthwise_multi_cuda,
               "K3": xk.xcorr_depthwise_pairwise_cuda}
    records = chip_smoke.single_checks(kernels, PLAIN, cuda, timed=False)
    assert all(r["max_abs_err"] <= r["tol"] for r in records)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 9, 10, 40))
                         .astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.normal(size=(2, 3, 3, 4, 40))
                         .astype(np.float32)).to(cuda)
    for tag, kk in (("K2", k), ("K3", k[:, 0].contiguous())):
        fn = kernels[tag]
        before = fn.launches
        out = fn(x, kk)
        assert fn.launches == before + 1
        torch.testing.assert_close(out, PLAIN[tag](x, kk), rtol=0,
                                   atol=1e-4 * max(float(out.abs().max()),
                                                   1.0))
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(1, 2), kk)
        with pytest.raises(ValueError, match="CUDA"):
            fn(x.cpu(), kk.cpu())
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(x.half(), kk.half())


@pytest.mark.gpu
def test_bf16_batchnorm_rounds_once_on_gpu():
    """Eval-mode BN's card branch (`batch_norm_elemt` with the kept
    `rsqrt(var + eps)`) on bf16 input against flax's `_normalize` written
    out and rounded once: at most `BN_FLIP_SHARE` of the cells one bf16
    ulp apart, none further (the CPU branch's test is
    `test_torch_port_bf16.py::test_batchnorm_rounds_once_as_flax`)."""
    rec = chip_smoke.bn_rounding_check(_cuda())
    assert rec["device"] == "cuda" and rec["max_ulps"] <= 1.0
    assert rec["flip_share"] <= chip_smoke.BN_FLIP_SHARE


@pytest.mark.gpu
def test_engine_chunk_makes_no_host_sync_on_gpu():
    """A batch-engine chunk on the card runs under
    `torch.cuda.set_sync_debug_mode("error")` and launches K1 three
    times per frame step."""
    cuda = _cuda()
    from usot_tpu_torch.models.calibrate import calibrate_batch_stats
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.tracker.engine import (BatchScanEngine,
                                               synthetic_video)
    from usot_tpu_torch.tracker.runner import ModelRunner

    model = init_model(build_usot(width=8, channels=32, fused_xcorr=True),
                       device=cuda)
    calibrate_batch_stats(model, n_iter=2)
    frames = synthetic_video(5, h=320, w=320)
    engine = BatchScanEngine(model, chip_smoke._tracker_config("small"),
                             320, 320, batch=2, max_frames=8, chunk=4,
                             device=cuda)
    state = engine.init_batch([(frames[0], np.array([200.0, 240.0]),
                                np.array([60.0, 60.0]))] * 2,
                              ModelRunner(model, device=cuda))
    lanes = np.stack([np.stack(frames[1:])] * 2)
    (_, block, valid), = engine.stage_frames(lanes, np.array([4, 3]))
    chip_smoke.reset_launch_counts()
    with chip_smoke.no_host_sync(cuda):
        state, outs = engine.run_chunk(state, block, valid)
    assert chip_smoke.launch_counts()["K1"] == 3 * 4
    assert state.mem_len.tolist() == [5, 4]
    assert bool(torch.isfinite(outs[0]).all())


@pytest.mark.gpu
def test_training_runs_on_gpu(tmp_path):
    """Phase 10 on the card at small width: the schedule, its resume
    within 1e-3, the step against the CPU (losses 1e-4, gradients and BN
    stats 1e-3), remat below the plain step's peak memory; no kernel."""
    cuda = _cuda()
    rec, launches = chip_smoke.run_training(
        cuda, width=8, channels=32, batch=2, mem=2, iters=2, timing_steps=1,
        out_dir=str(tmp_path))
    _check_training_record(rec, launches)
    steps = rec["steps"]
    assert steps["cycle_unfrozen_remat"]["peak_bytes"] \
        < steps["cycle_unfrozen"]["peak_bytes"]
    assert rec["profile_cycle_unfrozen"]["device_ms"] > 0


@pytest.mark.gpu
def test_training_bf16_runs_on_gpu(tmp_path):
    """Phase 12 on the card at small width: the bf16 schedule from the
    live loader, its resume within 1e-2, the step against the CPU within
    `bf16_training_vs_cpu`'s limits; no kernel."""
    cuda = _cuda()
    f32 = {k: {"ms_per_step": 1.0, "peak_bytes": None}
           for k in ("naive_frozen", "naive_unfrozen", "cycle_frozen",
                     "cycle_unfrozen")}
    rec, launches = chip_smoke.run_training_bf16(
        cuda, width=8, channels=32, batch=2, mem=2, iters=2, workers=2,
        timing_steps=1, f32_steps=f32, n_videos=3, pipe_steps=2,
        out_dir=str(tmp_path))
    _check_bf16_training_record(rec, launches)
    assert rec["profile_cycle_unfrozen"]["device_ms"] > 0
    assert 0.0 <= rec["pipelined"]["idle_share"] <= 1.0


@pytest.mark.gpu
def test_protocols_launch_k1_on_gpu(tmp_path):
    """Phase 9 on the card at small width: each protocol's path launches
    K1, three times per frame step of its chunks; ROI chunks cropped at
    a non-zero origin are accepted and agree with full frames."""
    cuda = _cuda()
    model = chip_smoke.build_model(cuda, width=8, channels=32, n_iter=2)
    rec, launches = chip_smoke.run_protocols(
        model, cuda, h=320, w=320, box=48, vot_lanes=3, vot_lengths=(20, 24),
        chunk=8, refill_lanes=2, refill_lengths=(3, 12), refill_videos=4,
        roi_lanes=2, roi_frames=8, roi_hw=(448, 512),
        out_dir=str(tmp_path))
    k1 = rec["k1_launches"]
    assert all(k1[k] > 0 and k1[k] % 3 == 0 for k in ("vot", "refill",
                                                       "roi"))
    assert launches == k1["total"]
    assert rec["donate"]["ring_copy_ms_b8_2048"] > 0
    roi, one = rec["roi"], rec["roi"]["one_frame_chunks"]
    assert roi["max_abs_err_px"] <= 1e-2 and one["max_abs_err_px"] <= 1e-2
    assert one["roi_accepted"] >= 1
    assert roi["roi_accepted"] > roi["roi_replays"] \
        and not roi["roi_fallback"]


@pytest.mark.gpu
def test_pseudo_labels_run_on_gpu():
    """Phase 13 on the card at 360x640 frames, test shape 192x320, 20
    frames: the mining path, the loop against the CPU, the forward's
    times and profile; no kernel."""
    rec, launches = chip_smoke.run_pseudo_labels(
        _cuda(), n_frames=20, h=360, w=640, test_shape=(192, 320))
    _check_mining_record(rec, launches, 20)
    assert rec["forward"]["device_ms"] > 0
    assert rec["profile"]["device_launches"] > 0
