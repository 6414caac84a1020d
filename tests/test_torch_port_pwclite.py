"""The port's flow network (`usot_tpu_torch.preprocessing.{correlation,
pwclite}`) against `usot_tpu.preprocessing` on the same numpy-seeded
inputs and weights, at scale-aware 1e-4 (the module limit of
`tests/test_reference_parity.py:34-39`); and the weight bridges: flax
variables through `pwclite_state_dict_from_flax`, and an ARFlow-layout
`.tar` read by both packages' `load_arflow_checkpoint`.

JAX never inits eagerly here (over a minute at 64x96): its variables
take their tree from `jax.eval_shape` and their values from numpy. The
whole network runs jitted, once per configuration (~9 s of compile
each; op by op the first call takes ~35 s), with `upsample=False`: its
upsampled flows are JAX's `resize_flow` of those, the code of
`PWCLite(upsample=True)`'s branch (`pwclite.py:247-249`, `:283-285`).
The worst error of each check is printed (`pytest -s`).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import usot_tpu.preprocessing.pwclite as jax_pwc
from usot_tpu.preprocessing.correlation import correlation as jax_corr
from usot_tpu.preprocessing.inference import FlowHelper as JaxFlowHelper
from usot_tpu.preprocessing.inference import \
    load_arflow_checkpoint as jax_load_arflow
from usot_tpu_torch.models.convert import pwclite_state_dict_from_flax
from usot_tpu_torch.preprocessing import pwclite
from usot_tpu_torch.preprocessing.correlation import correlation
from usot_tpu_torch.preprocessing.inference import (FlowHelper,
                                                    load_arflow_checkpoint)

from torch_port_common import jax_pwclite_variables, scaled_err

torch.set_num_threads(2)
TOL = 1e-4
H, W = 64, 96


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def check(tag, ours, ref, tol=TOL):
    err = scaled_err(ours, ref)
    print(f"{tag}: scaled err {err:.3g}")
    assert np.asarray(ours).shape == np.asarray(ref).shape, tag
    assert err <= tol, (tag, err)
    return err


def jax_variables(n_frames, reduce_dense):
    return jax_pwclite_variables(n_frames, reduce_dense, H, W)


_FORWARD = {}


def jax_coarse_flows(n_frames, reduce_dense, variables, x):
    """JAX's `PWCLite(upsample=False)` with `with_bk`, jitted once per
    configuration."""
    key = (n_frames, reduce_dense)
    if key not in _FORWARD:
        model = jax_pwc.PWCLite(n_frames=n_frames, reduce_dense=reduce_dense,
                                upsample=False)
        _FORWARD[key] = jax.jit(lambda v, x: model.apply(v, x, with_bk=True))
    return _FORWARD[key](variables, jnp.asarray(x))


def upsampled(flows):
    """`PWCLite(upsample=True)`'s branch on JAX's coarse flows."""
    return {k: [jax_pwc.resize_flow(f, f.shape[1] * 4, f.shape[2] * 4)
                for f in fl] for k, fl in flows.items()}


def port_model(n_frames, reduce_dense, upsample=True):
    model = pwclite.PWCLite(n_frames=n_frames, reduce_dense=reduce_dense,
                            upsample=upsample)
    model.load_state_dict(pwclite_state_dict_from_flax(
        jax_variables(n_frames, reduce_dense)))
    return model.eval()


def frames(seed, n_frames, h=H, w=W):
    """Stacked frames in [0, 1], smooth enough to give a structured flow:
    a textured block moving over a textured background."""
    rng = np.random.default_rng(seed)
    bg = rng.random((h + 16, w + 16, 3)).astype(np.float32)
    obj = rng.random((h // 3, w // 3, 3)).astype(np.float32)
    out = []
    for f in range(n_frames):
        im = bg[2 * f:2 * f + h, f:f + w].copy()
        y, x = h // 3 + f, w // 3 + 3 * f
        im[y:y + obj.shape[0], x:x + obj.shape[1]] = obj
        out.append(im)
    return np.concatenate(out, -1)[None]


@pytest.mark.parametrize("n_frames,reduce_dense", [
    (3, True), (3, False), (2, True), (2, False)],
    ids=["3f-reduce", "3f-dense", "2f-reduce-bk", "2f-dense-bk"])
def test_pwclite_matches_jax(n_frames, reduce_dense):
    """Every pyramid flow, forward and backward (2-frame mode with
    `with_bk`), with `upsample` on and off."""
    x = frames(n_frames, n_frames)
    coarse = jax_coarse_flows(n_frames, reduce_dense,
                              jax_variables(n_frames, reduce_dense), x)
    for upsample in (True, False):
        ref = upsampled(coarse) if upsample else coarse
        with torch.no_grad():
            ours = port_model(n_frames, reduce_dense, upsample)(
                nchw(x), with_bk=True)
        assert sorted(ours) == sorted(ref) == ["flows_bw", "flows_fw"]
        for key in ("flows_fw", "flows_bw"):
            assert len(ours[key]) == len(ref[key]) == 5
            for lvl, (o, r) in enumerate(zip(ours[key], ref[key])):
                check(f"{n_frames}f reduce={reduce_dense} up={upsample} "
                      f"{key}[{lvl}]", nhwc(o), np.asarray(r))
        if upsample:
            assert ours["flows_fw"][0].shape == (1, 2, H, W)


def test_flax_bridge_names_every_parameter():
    """`pwclite_state_dict_from_flax` gives exactly the port's keys and
    shapes in both estimators' layouts, and the conv kernels HWIO ->
    OIHW."""
    for n_frames, reduce_dense in ((3, True), (2, False)):
        v = jax_variables(n_frames, reduce_dense)
        sd = pwclite_state_dict_from_flax(v)
        model = pwclite.PWCLite(n_frames=n_frames, reduce_dense=reduce_dense)
        want = model.state_dict()
        assert sorted(sd) == sorted(want)
        assert all(sd[k].shape == want[k].shape for k in sd)
        last = "predict_flow" if reduce_dense else "conv_last"
        np.testing.assert_array_equal(
            sd[f"flow_estimators.{last}.0.weight"].numpy(),
            np.transpose(v["params"]["flow_estimators"][last]["conv"][
                "kernel"], (3, 2, 0, 1)))
    assert "feature_pyramid_extractor.convs.5.1.0.bias" in sd
    assert "context_networks.convs.6.0.weight" in sd
    assert "conv_1x1.4.0.weight" in sd


def test_submodules_match_jax():
    """ConvL (strided, dilated, 1x1, without ReLU), the feature pyramid,
    both estimators and the context network, on the 3-frame networks'
    weights at the finest level's shapes."""
    rng = np.random.default_rng(7)
    for reduce_dense in (True, False):
        v = jax_variables(3, reduce_dense)["params"]
        model = port_model(3, reduce_dense)
        with torch.no_grad():
            x = rng.random((2, H, W, 3)).astype(np.float32)
            ref = jax_pwc.FeatureExtractor().apply(
                {"params": v["feature_pyramid_extractor"]}, jnp.asarray(x))
            ours = model.feature_pyramid_extractor(nchw(x))
            assert len(ours) == len(ref) == 6
            for lvl, (o, r) in enumerate(zip(ours, ref)):
                check(f"pyramid[{lvl}]", nhwc(o), np.asarray(r))
            est = model.flow_estimators
            x = rng.normal(size=(1, 16, 24, 198)).astype(np.float32)
            cls = jax_pwc.FlowEstimatorReduce if reduce_dense \
                else jax_pwc.FlowEstimatorDense
            r_feat, r_flow = cls().apply({"params": v["flow_estimators"]},
                                         jnp.asarray(x))
            o_feat, o_flow = est(nchw(x))
            check(f"estimator reduce={reduce_dense} features", nhwc(o_feat),
                  np.asarray(r_feat))
            check(f"estimator reduce={reduce_dense} flow", nhwc(o_flow),
                  np.asarray(r_flow))
            x = rng.normal(size=(1, 16, 24, 2 * est.feat_dim + 4)).astype(
                np.float32)
            ref = jax_pwc.ContextNetwork().apply(
                {"params": v["context_networks"]}, jnp.asarray(x))
            check(f"context reduce={reduce_dense}",
                  nhwc(model.context_networks(nchw(x))), np.asarray(ref))
    # ConvL alone: strided, dilated, 1x1, linear
    for kw in (dict(kernel=3, stride=2), dict(kernel=3, dilation=4),
               dict(kernel=1), dict(kernel=3, relu=False)):
        x = rng.normal(size=(1, 11, 13, 5)).astype(np.float32)
        conv = jax_pwc.ConvL(7, **kw)
        shapes = jax.eval_shape(conv.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))
        k = shapes["params"]["conv"]["kernel"].shape
        p = {"conv": {"kernel": rng.normal(size=k).astype(np.float32),
                      "bias": rng.normal(size=(7,)).astype(np.float32)}}
        port = pwclite.ConvL(5, 7, **kw)
        port[0].weight.data = torch.from_numpy(
            np.transpose(p["conv"]["kernel"], (3, 2, 0, 1)).copy())
        port[0].bias.data = torch.from_numpy(p["conv"]["bias"])
        with torch.no_grad():
            check(f"ConvL {kw}", nhwc(port(nchw(x))),
                  np.asarray(conv.apply({"params": p}, jnp.asarray(x))))


@pytest.mark.parametrize("d,shape", [(4, (2, 7, 9, 5)), (1, (1, 5, 11, 3)),
                                     (4, (1, 3, 4, 6))])
def test_correlation_matches_jax(d, shape):
    """Odd sizes, a window wider than the map (3x4 at d=4)."""
    rng = np.random.default_rng(d + shape[1])
    x1 = rng.normal(size=shape).astype(np.float32)
    x2 = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_corr(jnp.asarray(x1), jnp.asarray(x2), d))
    ours = correlation(nchw(x1), nchw(x2), d)
    assert ours.shape == (shape[0], (2 * d + 1) ** 2, shape[1], shape[2])
    check(f"correlation d={d} {shape}", nhwc(ours), ref)


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((9, 11), (4, 5)),
                                     ((6, 8), (1, 13)), ((16, 24), (64, 96))])
def test_resize_bilinear_align_corners_matches_jax(src, dst):
    x = np.random.default_rng(src[0]).normal(
        size=(2, *src, 3)).astype(np.float32)
    ref = jax_pwc.resize_bilinear_align_corners(jnp.asarray(x), *dst)
    ours = pwclite.resize_bilinear_align_corners(nchw(x), *dst)
    check(f"resize {src}->{dst}", nhwc(ours), np.asarray(ref))


@pytest.mark.parametrize("channels", [2, 4])
def test_resize_flow_matches_jax(channels):
    """Every (dx, dy) pair rescaled, 3-frame mode's 4 channels too."""
    flow = np.random.default_rng(channels).normal(
        0, 3, (1, 6, 9, channels)).astype(np.float32)
    for dst in ((24, 36), (5, 4)):
        ref = jax_pwc.resize_flow(jnp.asarray(flow), *dst)
        ours = pwclite.resize_flow(nchw(flow), *dst)
        check(f"resize_flow {channels}ch ->{dst}", nhwc(ours),
              np.asarray(ref))


@pytest.mark.parametrize("kind", ["zero", "integer", "past_border"])
def test_flow_warp_matches_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 9, 5)).astype(np.float32)
    if kind == "zero":
        flow = np.zeros((2, 8, 9, 2), np.float32)
    elif kind == "integer":
        flow = np.broadcast_to(np.float32([2, -1]), (2, 8, 9, 2)).copy()
    else:  # sources far outside on every side, fractional
        flow = rng.uniform(-20, 20, (2, 8, 9, 2)).astype(np.float32)
    ref = np.asarray(jax_pwc.flow_warp(jnp.asarray(x), jnp.asarray(flow)))
    ours = nhwc(pwclite.flow_warp(nchw(x), nchw(flow)))
    check(f"flow_warp {kind}", ours, ref)
    if kind == "zero":
        np.testing.assert_array_equal(ours, x)
    if kind == "integer":
        np.testing.assert_array_equal(ours[:, 1:, :-2], x[:, :-1, 2:])


def test_arflow_tar_loads_in_both_packages(tmp_path):
    """A `.tar` in ARFlow's layout ({"epoch", "state_dict": {"module." +
    key}}), written from the port's `init_pwclite` weights: the port
    loads it strictly, JAX's loader reads it into flax variables, and
    both networks give the same flows; a tar missing a key is refused."""
    model = pwclite.init_pwclite(pwclite.PWCLite(),
                                 torch.Generator().manual_seed(5))
    state = {"module." + k: v for k, v in model.state_dict().items()}
    path = tmp_path / "pwclite_ar_mv.tar"
    torch.save({"epoch": 1, "state_dict": state}, path)

    helper = FlowHelper(test_shape=(H, W), device="cpu",
                        generator=torch.Generator().manual_seed(6))
    load_arflow_checkpoint(str(path), helper)
    for k, t in helper.model.state_dict().items():
        torch.testing.assert_close(t, model.state_dict()[k], rtol=0, atol=0)
    jax_helper = JaxFlowHelper(variables=jax_variables(3, True),
                               test_shape=(H, W))
    variables = jax_load_arflow(str(path), jax_helper)
    x = frames(11, 3)
    ref = upsampled(jax_coarse_flows(3, True, variables, x))
    with torch.no_grad():
        ours = helper.model(nchw(x))
    for lvl, (o, r) in enumerate(zip(ours["flows_fw"], ref["flows_fw"])):
        check(f"tar flows_fw[{lvl}]", nhwc(o), np.asarray(r))

    del state["module.conv_1x1.2.0.bias"]
    torch.save({"epoch": 1, "state_dict": state}, path)
    with pytest.raises(RuntimeError, match="conv_1x1.2.0.bias"):
        load_arflow_checkpoint(str(path), helper)


def test_init_pwclite_draws_flax_distributions():
    """lecun-normal kernels (truncated at 2 std of sqrt(1 / fan_in) /
    0.8796), zero biases; the same seed gives the same weights."""
    a = pwclite.init_pwclite(pwclite.PWCLite(),
                             torch.Generator().manual_seed(1))
    b = pwclite.init_pwclite(pwclite.PWCLite(),
                             torch.Generator().manual_seed(1))
    for (k, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(t, u, rtol=0, atol=0)
        if k.endswith("bias"):
            assert not t.any()
    w = a.context_networks.convs[0][0].weight.detach()
    fan_in = w.shape[1] * 9
    std = (1.0 / fan_in) ** 0.5
    assert float(w.std()) == pytest.approx(std, rel=0.05)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
