"""Shared helpers of the port's parity tests (`test_torch_port_*.py`)."""
import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_usot_w8c32.msgpack")
WIDTH, CHANNELS = 8, 32  # the committed fixture's widths


def load_fixture():
    """(model kwargs, flax variables) of the committed trained checkpoint."""
    from flax import serialization

    with open(FIXTURE, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    kw = dict(mem_size=int(restored["mem_size"]),
              width=int(restored["width"]),
              channels=int(restored["channels"]))
    return kw, {"params": restored["params"],
                "batch_stats": restored["batch_stats"]}


def random_variables(seed: int, bn_stats: bool = True):
    """Random flax variables with the fixture's tree: conv kernels drawn
    lecun-normal-like (std sqrt(1/fan_in)) from numpy, biases and BN
    affines jittered; BN stats jittered too, or flax's init (mean 0,
    var 1) with bn_stats=False. Cheaper than tracing a JAX init."""
    import jax

    rng = np.random.default_rng(seed)
    _, v = load_fixture()

    def draw(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "weight"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias" and path[-2].key != "connect":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "mean":
            return (rng.normal(0.0, 0.1, a.shape) if bn_stats
                    else np.zeros(a.shape)).astype(np.float32)
        if name == "var":
            return (rng.uniform(0.5, 1.5, a.shape) if bn_stats
                    else np.ones(a.shape)).astype(np.float32)
        return a

    return {k: jax.tree_util.tree_map_with_path(draw, v[k])
            for k in ("params", "batch_stats")}


# ---------------------------------------------------------------- training
#
# The training parity tests run one staged phase in both packages from the
# trained fixture: JAX's `make_train_step` + `build_optimizer` (jitted,
# once per phase) and the port's, on the same numpy batches.

LR, CLS_RATIO, LAMBDA_1 = 0.005, 0.5, 0.3
MOMENTUM, WEIGHT_DECAY, LAYERS_LR = 0.9, 1e-4, 0.1


def train_batch(seed, b, mem=None):
    """A numpy batch in the shard layout (channel-flat uint8 images) of
    `b` `training_sample`s (`usot_tpu_torch.tools.synthetic_shards`);
    cycle-memory with `mem` frames."""
    from usot_tpu_torch.data.shards import _pack_sample
    from usot_tpu_torch.tools.synthetic_shards import training_sample

    rng = np.random.default_rng(seed)
    packed = [_pack_sample(training_sample(rng, mem is not None, mem or 0))
              for _ in range(b)]
    return {k: np.stack([p[k] for p in packed]) for k in packed[0]}


def scaled_err(ours, ref):
    """max |ours - ref| / max(max |ref|, 1): the repo's scale-aware error
    (`tests/test_reference_parity.py:34-39`)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                 1.0)


def optax_momentum(opt_state, params):
    """optax's momentum (the `trace` of both trainable groups) as a full
    params tree, zeros where a group does not reach."""
    import jax
    import optax

    full = jax.tree.map(np.zeros_like, params)
    for label in ("backbone", "base"):
        inner = opt_state.inner_states[label].inner_state
        trace = next(s.trace for s in inner if hasattr(s, "trace"))
        full = jax.tree.map(
            lambda f, t: f if isinstance(t, optax.MaskedNode)
            else np.asarray(t), full, trace,
            is_leaf=lambda t: isinstance(t, optax.MaskedNode))
    return full


def torch_layout(params, stats):
    """flax trees -> {port state-dict key: numpy}."""
    from usot_tpu_torch.models.convert import state_dict_from_flax

    return {k: t.numpy() for k, t in state_dict_from_flax(
        {"params": params, "batch_stats": stats}).items()}


def jax_train_run(variables, cycle, unfix, batches, accum=1, seen=None,
                  x64=False):
    """JAX steps of one phase over `batches` from `variables`. Per step:
    {"metrics", "params", "momentum"} in the port's state-dict layout
    ("params" with the BN stats; momentum: optax's trace). `seen`, a list,
    receives the cycle-memory `forward_res` of every step (the input of
    the argmax). x64: the model and its variables in float64."""
    import jax
    import jax.numpy as jnp
    import pytest

    import usot_tpu.models.usot as jax_usot
    from usot_tpu.train.optim import build_optimizer
    from usot_tpu.train.step import TrainState, make_train_step

    kw, _ = load_fixture()
    if x64:
        kw["dtype"] = jnp.float64
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 variables)
    model = jax_usot.build_usot(**kw)
    out = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
        tx, _ = build_optimizer(variables["params"], MOMENTUM, WEIGHT_DECAY,
                                LAYERS_LR, unfix)
        state = TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]))
        step = make_train_step(model, tx, cycle, unfix, LAMBDA_1,
                               accum_steps=accum)
        if seen is not None:
            argmax = jnp.argmax

            def recorded(x, axis=None, **kwargs):
                jax.debug.callback(lambda a: seen.append(np.asarray(a)), x)
                return argmax(x, axis=axis, **kwargs)

            mp.setattr(jax_usot.jnp, "argmax", recorded)
        for batch in batches:
            state, met = step(state, batch, jnp.float32(LR),
                              jnp.float32(CLS_RATIO))
            params = jax.tree.map(np.asarray, state.params)
            stats = jax.tree.map(np.asarray, state.batch_stats)
            out.append({"metrics": {k: float(v) for k, v in met.items()},
                        "params": torch_layout(params, stats),
                        "momentum": torch_layout(
                            optax_momentum(state.opt_state, params), stats)})
    return out


def port_model(variables, dtype=None):
    import torch

    from usot_tpu_torch.models.convert import state_dict_from_flax
    from usot_tpu_torch.models.usot import build_usot

    kw, _ = load_fixture()
    model = build_usot(**kw)
    model.load_state_dict(state_dict_from_flax(variables))
    return model.to(torch.device("cpu"), dtype or torch.float32)


def port_train_run(variables, cycle, unfix, batches, accum=1, remat=False,
                   seen=None, dtype=None):
    """The port's steps of one phase over `batches`, as `jax_train_run`
    records them, plus "grads" (`.grad` after the step); also returns the
    parameter labels."""
    import pytest
    import torch

    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    model = port_model(variables, dtype)
    opt, labels = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR,
                                  unfix)
    step = make_train_step(model, opt, cycle, unfix, LAMBDA_1, remat=remat,
                           accum_steps=accum)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if seen is not None:
            argmax = torch.argmax

            def recorded(x, dim=None, **kwargs):
                seen.append(x.detach().numpy().copy())
                return argmax(x, dim=dim, **kwargs)

            mp.setattr(torch, "argmax", recorded)
        for batch in batches:
            met = step({k: torch.from_numpy(v) for k, v in batch.items()},
                       LR, CLS_RATIO)
            sd = {k: t.detach().numpy().copy()
                  for k, t in model.state_dict().items()}
            out.append({
                "metrics": {k: float(v) for k, v in met.items()},
                "params": sd,
                "grads": {n: p.grad.numpy().copy()
                          for n, p in model.named_parameters()
                          if p.grad is not None},
                "momentum": {n: opt.state[p]["momentum_buffer"].numpy()
                             .copy() for n, p in model.named_parameters()
                             if p in opt.state},
            })
    return out, labels
