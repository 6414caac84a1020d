"""Port model (`usot_tpu_torch.models`) against `usot_tpu.models`, per method.

Identical weights go into both packages through the port's
`state_dict_from_flax`: random JAX init (with randomised BN stats) and
the committed trained fixture `tests/fixtures/tiny_usot_w8c32.msgpack`.
Inputs are numpy-seeded; activations must agree within scale-aware 1e-4
(`tests/test_reference_parity.py:34-39`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usot_tpu.models.convert import invert_usot_checkpoint
from usot_tpu.models.usot import USOTNet as JaxNet
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu_torch.models.convert import state_dict_from_flax, strip_prefix
from usot_tpu_torch.models.usot import build_usot, init_model

from torch_port_common import CHANNELS, WIDTH, load_fixture, random_variables

# Several test workers share the host's cores; tiny shapes need few threads.
torch.set_num_threads(2)


def assert_close(ours, ref, tol=1e-4):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    atol = tol * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


@pytest.fixture(scope="module", params=["random", "fixture"])
def pair(request):
    """(jax model, variables, port model loaded with the same weights,
    input amplitude: pixel-scale for the trained fixture)."""
    v = random_variables(3) if request.param == "random" \
        else load_fixture()[1]
    jm = jax_build(mem_size=2, width=WIDTH, channels=CHANNELS)
    pm = build_usot(mem_size=2, width=WIDTH, channels=CHANNELS,
                    fused_xcorr=True)
    pm.load_state_dict(state_dict_from_flax(v))
    amp = 1.0 if request.param == "random" else 255.0
    return jm, v, pm.eval(), amp


def _rand(rng, shape, scale=1.0):
    return (rng.random(shape) if scale == 255.0
            else rng.normal(size=shape)).astype(np.float32) * scale


def _both(jm, v, pm, method, *args):
    """Run `method` in both packages on the same numpy args."""
    j_out = jm.apply(v, *[jnp.asarray(a) for a in args],
                     method=getattr(JaxNet, method))
    with torch.no_grad():
        p_out = getattr(pm, method)(*[torch.from_numpy(a) for a in args])
    return j_out, p_out


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("size,expect", [(127, 15), (255, 31), (271, 33)])
def test_backbone(pair, size, expect):
    jm, v, pm, amp = pair
    x = _rand(np.random.default_rng(size), (1, size, size, 3), amp)
    ref = jm.apply(v, jnp.asarray(x), method=lambda m, a: m.features(a))
    with torch.no_grad():
        out = pm.features(torch.from_numpy(x))
    assert out.shape == (1, expect, expect, 16 * WIDTH)
    assert_close(out, ref)


@pytest.mark.parametrize("mode", ["plain", "prpool", "center"])
def test_neck(pair, mode):
    jm, v, pm, _ = pair
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 15, 15, 16 * WIDTH)).astype(np.float32)
    bbox = np.array([[3.0, 3.5, 11.0, 10.0], [-1.0, 2.0, 9.0, 16.0]],
                    np.float32)
    kw = {"plain": dict(crop=False),
          "prpool": dict(crop=True, pr_pool=True),
          "center": dict(crop=True, pr_pool=False)}[mode]
    jbox = jnp.asarray(bbox) if mode == "prpool" else None
    ref = jm.apply(v, jnp.asarray(x),
                   method=lambda m, a: m.neck(a, bbox=jbox, **kw))
    with torch.no_grad():
        out = pm.neck(torch.from_numpy(x),
                      bbox=torch.from_numpy(bbox) if jbox is not None
                      else None, **kw)
    for o, r in zip(_flat(out), _flat(ref)):
        assert_close(o, r)


def test_template_features(pair):
    jm, v, pm, amp = pair
    z = _rand(np.random.default_rng(12), (1, 127, 127, 3), amp)
    tb = np.array([[3.0, 3.0, 11.0, 11.5]], np.float32)
    for o, r in zip(*map(_flat, _both(jm, v, pm, "template_features",
                                      z, tb)[::-1])):
        assert_close(o, r)


@pytest.mark.parametrize("size", [255, 271])
def test_search_features(pair, size):
    jm, v, pm, amp = pair
    x = _rand(np.random.default_rng(size + 1), (1, size, size, 3), amp)
    ref, out = _both(jm, v, pm, "search_features", x)
    assert_close(out, ref)


def _head_inputs(seed, b=1, n_q=7, s=31):
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(b, s, s, CHANNELS)).astype(np.float32)
    zf = rng.normal(size=(b, 7, 7, CHANNELS)).astype(np.float32)
    mem = rng.normal(size=(b * n_q, 7, 7, CHANNELS)).astype(np.float32)
    return xf, zf, mem


def test_track_offline(pair):
    jm, v, pm, _ = pair
    xf, zf, _ = _head_inputs(13)
    ref, out = _both(jm, v, pm, "track_offline", xf, zf)
    for o, r in zip(_flat(out), _flat(ref)):
        assert_close(o, r)


@pytest.mark.parametrize("s", [31, 33])
def test_track_memory(pair, s):
    jm, v, pm, _ = pair
    xf, zf, mem = _head_inputs(14, s=s)
    ref, out = _both(jm, v, pm, "track_memory", xf, zf, mem)
    assert out[2].shape == (1, s - 6, s - 6, 1)
    for o, r in zip(_flat(out), _flat(ref)):
        assert_close(o, r)


def test_track_memory_batched(pair):
    jm, v, pm, _ = pair
    xf, zf, mem = _head_inputs(15, b=2, n_q=3)
    mem = mem.reshape(2, 3, 7, 7, CHANNELS)
    ref, out = _both(jm, v, pm, "track_memory_batched", xf, zf, mem)
    for o, r in zip(_flat(out), _flat(ref)):
        assert_close(o, r)


def test_encode_template_and_memory_kernels(pair):
    jm, v, pm, _ = pair
    _, zf, mem = _head_inputs(16)
    for method, arg in (("encode_template", zf),
                        ("encode_memory_kernels", mem)):
        ref, out = _both(jm, v, pm, method, arg)
        assert len(_flat(out)) == len(_flat(ref))
        for o, r in zip(_flat(out), _flat(ref)):
            assert_close(o, r)


def test_track_memory_encoded(pair):
    jm, v, pm, _ = pair
    xf, zf, mem = _head_inputs(17)
    ref_enc, out_enc = _both(jm, v, pm, "encode_template", zf)
    ref_q, out_q = _both(jm, v, pm, "encode_memory_kernels", mem)
    ref = jm.apply(v, jnp.asarray(xf), ref_enc, ref_q,
                   method=JaxNet.track_memory_encoded)
    with torch.no_grad():
        out = pm.track_memory_encoded(torch.from_numpy(xf), out_enc, out_q)
    for o, r in zip(_flat(out), _flat(ref)):
        assert_close(o, r)


def test_track_memory_encoded_batched(pair):
    jm, v, pm, _ = pair
    b, n_q = 2, 3
    xf, zf, mem = _head_inputs(18, b=b, n_q=n_q)
    ref_enc, out_enc = _both(jm, v, pm, "encode_template", zf)
    ref_q, out_q = _both(jm, v, pm, "encode_memory_kernels", mem)
    ref_q = tuple(q.reshape((b, n_q) + q.shape[1:]) for q in ref_q)
    out_q = tuple(q.reshape((b, n_q) + q.shape[1:]) for q in out_q)
    ref = jm.apply(v, jnp.asarray(xf), ref_enc, ref_q,
                   method=JaxNet.track_memory_encoded_batched)
    with torch.no_grad():
        out = pm.track_memory_encoded_batched(torch.from_numpy(xf), out_enc,
                                              out_q)
    for o, r in zip(_flat(out), _flat(ref)):
        assert_close(o, r)


def test_pool_memory_feature(pair):
    jm, v, pm, _ = pair
    xf, _, _ = _head_inputs(19, b=2)
    bbox = np.array([[4.0, 5.0, 20.5, 18.0], [-1.0, 0.5, 26.0, 31.5]],
                    np.float32)
    ref, out = _both(jm, v, pm, "pool_memory_feature", xf, bbox)
    assert_close(out, ref)


def test_fused_and_pairwise_correlation_agree(pair):
    """fused_xcorr=True (one GroupDW call per head) and the repeat +
    pairwise grouped-conv route give the same outputs."""
    _, v, pm, _ = pair
    plain = build_usot(mem_size=2, width=WIDTH, channels=CHANNELS)
    plain.load_state_dict(pm.state_dict())
    xf, zf, mem = (torch.from_numpy(a) for a in _head_inputs(20))
    with torch.no_grad():
        for o, r in zip(pm.eval().track_memory(xf, zf, mem),
                        plain.eval().track_memory(xf, zf, mem)):
            assert_close(o, r.numpy())


def test_loads_inverted_checkpoint_strictly():
    """`invert_usot_checkpoint` output (numpy, reference key layout, no
    `num_batches_tracked`) loads with strict=True and equals the port's
    own bridge."""
    _, v = load_fixture()
    pm = build_usot(mem_size=2, width=WIDTH, channels=CHANNELS)
    result = pm.load_state_dict(invert_usot_checkpoint(v), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    ours = state_dict_from_flax(v)
    state = pm.state_dict()
    assert set(ours) == {k for k in state
                         if not k.endswith("num_batches_tracked")}
    for k, t in ours.items():
        assert torch.equal(state[k], t), k


def test_loads_prefixed_reference_state_dict():
    """A published checkpoint's `module.`-prefixed keys load after
    `strip_prefix`."""
    _, v = load_fixture()
    ours = state_dict_from_flax(v)
    pm = build_usot(mem_size=2, width=WIDTH, channels=CHANNELS)
    pm.load_state_dict(strip_prefix({"module." + k: t
                                     for k, t in ours.items()}))
    assert torch.equal(pm.state_dict()["connect_model.bias"],
                       ours["connect_model.bias"])


def test_init_model_draws_flax_distributions():
    pm = init_model(build_usot(width=WIDTH, channels=CHANNELS),
                    torch.Generator().manual_seed(0), device="cpu")
    w = pm.features.features.layer3[1].conv2.weight.detach()
    fan_in = w.shape[1] * 9
    # truncated at 2 std: the drawn std is sqrt(1/fan_in)
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 \
        / np.sqrt(fan_in) + 1e-6
    bn = pm.features.features.bn1
    assert torch.all(bn.weight == 1) and torch.all(bn.running_var == 1)
    head = pm.connect_model
    assert torch.all(head.cls_dw.weight == 1)
    assert float(head.adjust.detach()) == pytest.approx(0.1)
    assert torch.all(head.bias == 1) and torch.all(head.bbox_pred.bias == 0)
    again = init_model(build_usot(width=WIDTH, channels=CHANNELS),
                       torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.features.features.conv1.weight,
                       pm.features.features.conv1.weight)


def test_kernel_inputs_are_contiguous_nhwc(monkeypatch):
    """Every GroupDW call of the fused model, calibration included, hands
    the kernel contiguous tensors (its wrapper refuses anything else)."""
    import usot_tpu_torch.models.head as head
    from usot_tpu_torch.models.calibrate import calibrate_batch_stats
    from usot_tpu_torch.ops.xcorr import xcorr_groupdw_reference

    calls = []

    def checked(xs, ks):
        assert all(t.is_contiguous() for t in (*xs, *ks))
        calls.append(ks[0].shape[1])
        return xcorr_groupdw_reference(xs, ks)

    monkeypatch.setattr(head, "xcorr_groupdw", checked)
    pm = init_model(build_usot(width=WIDTH, channels=CHANNELS,
                               fused_xcorr=True), device="cpu")
    calibrate_batch_stats(pm, n_iter=1)
    xf, zf, mem = (torch.from_numpy(a) for a in _head_inputs(21))
    with torch.no_grad():
        pm.track_memory(xf, zf, mem)
    assert calls[-3:] == [1, 1, 7]
