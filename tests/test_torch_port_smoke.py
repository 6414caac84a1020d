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
    assert len(records) == 15
    assert [r["out"][1:4] for r in records[:4]] == [
        [1, 25, 25], [7, 25, 25], [1, 27, 27], [7, 27, 27]]
    assert [r["out"][:2] for r in records[4:6]] == [[32, 1], [32, 7]]
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
    """K3 at B=32 in bf16 is bytes-bound (~24.4 MB); K2 at M=7 in bf16
    is at the knee, just operations-bound (1.79 GFLOP)."""
    x = torch.empty(32, 29, 29, 256, dtype=torch.bfloat16)
    k3 = torch.empty(32, 5, 5, 256, dtype=torch.bfloat16)
    out3 = torch.empty(32, 25, 25, 256, dtype=torch.bfloat16)
    ms, by = chip_smoke.roofline([x, k3], out3, 25)
    assert by == "bytes" and ms == pytest.approx(7.292e-3, rel=1e-3)
    k2 = torch.empty(32, 7, 5, 5, 256, dtype=torch.bfloat16)
    out2 = torch.empty(32, 7, 25, 25, 256, dtype=torch.bfloat16)
    ms, by = chip_smoke.roofline([x, k2], out2, 25)
    assert by == "operations" and ms == pytest.approx(2.6746e-2, rel=1e-3)


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
               for r in heads.values())
    rec, launches = chip_smoke.run_scan_engine(model, CPU, n_frames=9,
                                               chunk=4, h=320, w=320)
    assert launches == 0 and rec["frames"] == 8


def test_slice_runs_at_small_width():
    model, results, launches = chip_smoke.run_slice(
        CPU, width=8, channels=32, n_frames=3, n_iter=1)
    assert launches == 0  # CPU tensors never reach the kernel
    assert [r["frames_tracked"] for r, _ in results] == [2, 2]
    errs = chip_smoke.parity_vs_cpu(model, results, CPU)
    assert set(errs) == {"search_features", "cls", "bbox", "cls_mem"}


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
