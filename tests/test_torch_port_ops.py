"""Port ops (`usot_tpu_torch.ops`) against their `usot_tpu` counterparts.

Same numpy-seeded inputs through both packages on the CPU, f32 unless a
test says otherwise. The fused GroupDW (K1) and the single-scale
correlations (K2, K3) are held against their Pallas kernels run in
interpret mode, at 1e-4 as `tests/test_ops.py` holds the kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usot_tpu.ops.pallas.xcorr_kernel import (xcorr_depthwise_multi_pallas,
                                              xcorr_depthwise_pallas,
                                              xcorr_groupdw_pallas)
from usot_tpu.ops.prroi import prroi_pool_same_batch as jax_prroi
from usot_tpu.ops.xcorr import xcorr_depthwise as jax_xcorr_depthwise
from usot_tpu.ops.xcorr import xcorr_groupdw as jax_xcorr_groupdw
from usot_tpu_torch.ops import xcorr_kernel
from usot_tpu_torch.ops.prroi import prroi_pool_same_batch
from usot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                      xcorr_depthwise_multi,
                                      xcorr_depthwise_multi_reference,
                                      xcorr_depthwise_pairwise,
                                      xcorr_depthwise_pairwise_reference,
                                      xcorr_groupdw, xcorr_groupdw_reference)

# Several test workers share the host's cores; tiny shapes need few threads.
torch.set_num_threads(2)


def _groupdw_inputs(rng, b, m, c, hx, wx, dtype=np.float32):
    """Three scales whose 5x5, 3x5 and 5x3 kernels meet at one Ho x Wo."""
    x_shapes = [(b, hx, wx, c), (b, hx - 2, wx, c), (b, hx, wx - 2, c)]
    k_shapes = [(b, m, 5, 5, c), (b, m, 3, 5, c), (b, m, 5, 3, c)]
    xs = [rng.normal(size=s).astype(dtype) for s in x_shapes]
    ks = [rng.normal(size=s).astype(dtype) for s in k_shapes]
    return xs, ks


GROUPDW_SHAPES = [
    # (B, M, C, Hx, Wx): tests/test_ops.py:245-251, M=1, and the
    # production 29/27 -> 25 geometry (instance 255) at C=8
    (2, 3, 128, 9, 9),
    (2, 1, 128, 9, 9),
    (1, 7, 8, 29, 29),
    (1, 1, 8, 29, 29),
    (3, 5, 8, 11, 13),
]


@pytest.mark.parametrize("shape", GROUPDW_SHAPES)
def test_groupdw_matches_pallas_interpret(shape):
    rng = np.random.default_rng(sum(shape))
    xs, ks = _groupdw_inputs(rng, *shape)
    ref = xcorr_groupdw_pallas([jnp.asarray(x) for x in xs],
                               [jnp.asarray(k) for k in ks], interpret=True)
    out = xcorr_groupdw([torch.from_numpy(x) for x in xs],
                        [torch.from_numpy(k) for k in ks])
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_groupdw_bf16_matches_jax_route():
    """bf16 inputs, both against the f64 sum of the same bf16 values. The
    port accumulates in f32 and rounds once (bf16 unit roundoff 2^-8):
    within 2^-7 of the largest output. The JAX non-Pallas route rounds
    each scale's map and each partial sum to bf16 (five roundings):
    within 2^-5."""
    rng = np.random.default_rng(7)
    xs, ks = _groupdw_inputs(rng, 2, 3, 16, 9, 9)
    xs_b = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    ks_b = [torch.from_numpy(k).to(torch.bfloat16) for k in ks]
    out = xcorr_groupdw(xs_b, ks_b)
    assert out.dtype == torch.bfloat16
    j_out = jax_xcorr_groupdw(
        [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs_b],
        [jnp.asarray(k.float().numpy(), jnp.bfloat16) for k in ks_b],
        use_pallas=False)
    exact = xcorr_groupdw_reference([x.double() for x in xs_b],
                                    [k.double() for k in ks_b]).numpy()
    scale = np.abs(exact).max()
    np.testing.assert_allclose(out.double().numpy(), exact,
                               atol=2.0 ** -7 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(j_out, np.float64), exact,
                               atol=2.0 ** -5 * scale, rtol=0)
    np.testing.assert_allclose(out.double().numpy(),
                               np.asarray(j_out, np.float64),
                               atol=2.0 ** -5 * scale, rtol=0)


@pytest.mark.parametrize("xs,ks", [((2, 31, 31, 8), (2, 5, 5, 8)),
                                   ((1, 27, 29, 4), (1, 3, 5, 4)),
                                   ((3, 10, 10, 16), (3, 3, 1, 16))])
def test_xcorr_depthwise_matches_jax(xs, ks):
    rng = np.random.default_rng(1)
    x = rng.normal(size=xs).astype(np.float32)
    k = rng.normal(size=ks).astype(np.float32)
    out = xcorr_depthwise(torch.from_numpy(x), torch.from_numpy(k))
    ref = jax_xcorr_depthwise(jnp.asarray(x), jnp.asarray(k))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


SINGLE_SHAPES = [
    # (B, Hx, Wx, C, Hk, Wk): tests/test_ops.py:225-227 at C <= 32, and a
    # ragged one (odd C, odd Wo)
    (2, 31, 31, 32, 5, 5),
    (1, 27, 29, 16, 3, 5),
    (2, 29, 27, 8, 5, 3),
    (3, 12, 15, 5, 4, 3),
]


@pytest.mark.parametrize("shape", SINGLE_SHAPES)
@pytest.mark.parametrize("m", [1, 3])
def test_depthwise_multi_matches_pallas_interpret(shape, m):
    """K2's plain version (the dispatch on CPU tensors) against
    `xcorr_depthwise_multi_pallas`."""
    b, hx, wx, c, hk, wk = shape
    rng = np.random.default_rng(sum(shape) + m)
    x = rng.normal(size=(b, hx, wx, c)).astype(np.float32)
    k = rng.normal(size=(b, m, hk, wk, c)).astype(np.float32)
    ref = xcorr_depthwise_multi_pallas(jnp.asarray(x), jnp.asarray(k),
                                       interpret=True)
    out = xcorr_depthwise_multi(torch.from_numpy(x), torch.from_numpy(k))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("shape", SINGLE_SHAPES)
def test_depthwise_pairwise_matches_pallas_interpret(shape):
    """K3's plain version against `xcorr_depthwise_pallas`."""
    b, hx, wx, c, hk, wk = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, hx, wx, c)).astype(np.float32)
    k = rng.normal(size=(b, hk, wk, c)).astype(np.float32)
    ref = xcorr_depthwise_pallas(jnp.asarray(x), jnp.asarray(k),
                                 interpret=True)
    out = xcorr_depthwise_pairwise(torch.from_numpy(x), torch.from_numpy(k))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    # the grouped-conv route computes the same function
    np.testing.assert_allclose(
        xcorr_depthwise(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        out.numpy(), atol=1e-4, rtol=0)


def test_depthwise_bf16_rounds_once():
    """bf16 in, bf16 out, accumulated in f32: within 2^-7 of the largest
    output of the exact sum of the same bf16 values."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 11, 12, 16))
                         .astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(2, 3, 5, 4, 16))
                         .astype(np.float32)).to(torch.bfloat16)
    exact = xcorr_depthwise_multi_reference(x.double(), k.double())
    tol = 2.0 ** -7 * float(exact.abs().max())
    multi = xcorr_depthwise_multi(x, k)
    pair = xcorr_depthwise_pairwise(x, k[:, 1])
    assert multi.dtype == pair.dtype == torch.bfloat16
    np.testing.assert_allclose(multi.double().numpy(), exact.numpy(),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(pair.double().numpy(), exact[:, 1].numpy(),
                               atol=tol, rtol=0)


def test_cpu_tensors_never_launch_the_single_scale_kernels():
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(1, 9, 9, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 3, 3, 8)).astype(np.float32))
    before = (xcorr_kernel.xcorr_depthwise_multi_cuda.launches,
              xcorr_kernel.xcorr_depthwise_pairwise_cuda.launches)
    xcorr_depthwise_multi(x, k)
    xcorr_depthwise_pairwise(x, k[:, 0])
    assert (xcorr_kernel.xcorr_depthwise_multi_cuda.launches,
            xcorr_kernel.xcorr_depthwise_pairwise_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        xcorr_kernel.xcorr_depthwise_multi_cuda(x, k)
    with pytest.raises(ValueError, match="CUDA"):
        xcorr_kernel.xcorr_depthwise_pairwise_cuda(x, k[:, 0])
    np.testing.assert_allclose(
        xcorr_depthwise_pairwise_reference(x, k[:, 0]).numpy(),
        xcorr_depthwise_multi_reference(x, k)[:, 0].numpy(), atol=0, rtol=0)


def test_cpu_tensor_never_launches_the_kernel():
    rng = np.random.default_rng(2)
    xs, ks = _groupdw_inputs(rng, 1, 2, 8, 9, 9)
    before = xcorr_kernel.xcorr_groupdw_cuda.launches
    xcorr_groupdw([torch.from_numpy(x) for x in xs],
                  [torch.from_numpy(k) for k in ks])
    assert xcorr_kernel.xcorr_groupdw_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper has no fallback: a CPU tensor is an error."""
    rng = np.random.default_rng(3)
    xs, ks = _groupdw_inputs(rng, 1, 1, 8, 9, 9)
    with pytest.raises(ValueError, match="CUDA"):
        xcorr_kernel.xcorr_groupdw_cuda([torch.from_numpy(x) for x in xs],
                                        [torch.from_numpy(k) for k in ks])


def test_groupdw_rejects_mismatched_scales():
    rng = np.random.default_rng(4)
    xs, ks = _groupdw_inputs(rng, 1, 1, 8, 9, 9)
    xs[1] = xs[1][:, :-1]
    with pytest.raises(ValueError, match="output size"):
        xcorr_groupdw_reference([torch.from_numpy(x) for x in xs],
                                [torch.from_numpy(k) for k in ks])


BOXES = np.array([
    [2.0, 3.0, 9.5, 10.0],      # inside
    [-3.0, -2.0, 4.0, 5.0],     # leaves the image top-left
    [8.0, 9.0, 14.0, 15.5],     # leaves the image bottom-right
    [5.0, 5.0, 5.0, 9.0],       # zero width
    [6.0, 7.0, 4.0, 3.0],       # inverted: zero area
    [-9.0, -9.0, -4.0, -5.0],   # wholly outside
], np.float32)


def test_prroi_matches_jax():
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(len(BOXES), 11, 12, 5)).astype(np.float32)
    ref = jax_prroi(jnp.asarray(feat), jnp.asarray(BOXES), pooled=7)
    out = prroi_pool_same_batch(torch.from_numpy(feat),
                                torch.from_numpy(BOXES), pooled=7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert np.all(out.numpy()[3:5] == 0.0)


def test_prroi_gradients_match_jax():
    """Feature and RoI-coordinate gradients of a fixed weighted sum."""
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(len(BOXES), 11, 12, 5)).astype(np.float32)
    wts = rng.normal(size=(len(BOXES), 7, 7, 5)).astype(np.float32)

    def jloss(f, b):
        return jnp.sum(jax_prroi(f, b, pooled=7) * wts)

    jg_f, jg_b = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat),
                                                 jnp.asarray(BOXES))
    f_t = torch.from_numpy(feat).requires_grad_(True)
    b_t = torch.from_numpy(BOXES.copy()).requires_grad_(True)
    (prroi_pool_same_batch(f_t, b_t, pooled=7)
     * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(jg_f),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(jg_b),
                               atol=1e-4, rtol=1e-4)
