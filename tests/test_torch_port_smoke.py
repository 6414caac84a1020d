"""`chip_smoke.py`'s checks rehearsed on the CPU at a small size, and the
kernel on the card.

The script itself needs a GPU; its phases take the kernel and the device
as arguments, so here the plain version stands in for the kernel. This
keeps the checks, the grouped-conv yardstick's layout and the slice's
control flow tested where there is no card. This file imports no JAX, so
on a machine with a GPU and without JAX it runs as
`python -m pytest --noconftest tests/test_torch_port_smoke.py`
(`tests/conftest.py` imports JAX); the kernel test skips without a card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from usot_tpu_torch.ops.xcorr import xcorr_groupdw_reference

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_kernel_checks_pass_the_plain_version():
    records = chip_smoke.kernel_checks(xcorr_groupdw_reference,
                                       xcorr_groupdw_reference, CPU, c=16,
                                       timed=False)
    assert len(records) == 6
    assert [r["out"][1:4] for r in records[:4]] == [
        [1, 25, 25], [7, 25, 25], [1, 27, 27], [7, 27, 27]]
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


def test_slice_runs_at_small_width():
    model, results, launches = chip_smoke.run_slice(
        CPU, width=8, channels=32, n_frames=3, n_iter=1)
    assert launches == 0  # CPU tensors never reach the kernel
    assert [r["frames_tracked"] for r, _ in results] == [2, 2]
    errs = chip_smoke.parity_vs_cpu(model, results, CPU)
    assert set(errs) == {"search_features", "cls", "bbox", "cls_mem"}


def test_groupdw_kernel_on_gpu():
    """The CUDA kernel against its plain version on the card: f32 at the
    production shapes and a ragged one (1e-4 scale-aware, the Pallas
    kernel's tolerance), with one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
