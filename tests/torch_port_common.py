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
                  x64=False, bf16=False):
    """JAX steps of one phase over `batches` from `variables`. Per step:
    {"metrics", "params", "momentum"} in the port's state-dict layout
    ("params" with the BN stats; momentum: optax's trace). `seen`, a list,
    receives the cycle-memory `forward_res` of every step (the input of
    the argmax). x64: the model and its variables in float64; bf16: the
    model computes in bfloat16 (`USOTNet.dtype`), its variables float32."""
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
    if bf16:
        kw["dtype"] = jnp.bfloat16
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


def port_model(variables, dtype=None, compute=None):
    """The fixture's model with `variables`, its parameters in `dtype`
    (default float32), computing in `compute` (e.g. torch.bfloat16)."""
    import torch

    from usot_tpu_torch.models.convert import state_dict_from_flax
    from usot_tpu_torch.models.usot import build_usot

    kw, _ = load_fixture()
    model = build_usot(**kw, **({} if compute is None
                                else {"dtype": compute}))
    model.load_state_dict(state_dict_from_flax(variables))
    return model.to(torch.device("cpu"), dtype or torch.float32)


def port_train_run(variables, cycle, unfix, batches, accum=1, remat=False,
                   seen=None, dtype=None, compute=None):
    """The port's steps of one phase over `batches`, as `jax_train_run`
    records them, plus "grads" (`.grad` after the step); also returns the
    parameter labels. dtype / compute: as `port_model`'s."""
    import pytest
    import torch

    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    model = port_model(variables, dtype, compute)
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


# JAX's steps with XLA's excess precision off: inside `jit`, XLA may keep
# a bfloat16 fusion's intermediates in float32
# (`xla_allow_excess_precision`), which no op-by-op implementation
# reproduces; with it off, each bfloat16 op of JAX's step rounds as it
# would run op by op (as `test_torch_port_bf16.py` runs JAX). The flag
# is read when XLA's backend starts, so these runs get a process of
# their own.
_JAX_RUNS = """
import pickle, sys
sys.path[:0] = {paths!r}
import conftest  # JAX on the CPU, as in the tests
from torch_port_common import jax_train_run, load_fixture, train_batch
_, v = load_fixture()
out = {{}}
for key, (cycle, unfix, seeds, b, mem, accum) in {cases!r}.items():
    batches = [train_batch(s, b, mem) for s in seeds]
    out[key] = {{bf16: jax_train_run(v, cycle, unfix, batches, accum=accum,
                                    bf16=bf16) for bf16 in (False, True)}}
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


def start_jax_runs(path, cases):
    """Start a process that writes, to `path` (a pickle), `{key: {False:
    JAX's float32 run, True: its bfloat16 run}}` for each case `key:
    (cycle, unfix, batch seeds, batch, memory frames or None, accum)`,
    with XLA's excess precision off. Returns the process; read the
    result with `finish_jax_runs`."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_allow_excess_precision=false").strip())
    script = _JAX_RUNS.format(paths=[here, os.path.dirname(here)],
                              cases=cases, path=str(path))
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish_jax_runs(proc, path, timeout=600):
    import pickle

    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def rel_rms(ours, ref):
    """||ours - ref|| / ||ref|| over the concatenated arrays."""
    ours = np.concatenate([np.ravel(np.asarray(a, np.float64))
                           for a in ours])
    ref = np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in ref])
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref),
                                                  1e-30))


def stage_cosines(grads, ref, labels):
    """Cosine between two `bf16_step_views` "grads" lists over each
    stage's trainable parameters: a backbone stage
    (`features.features.layerN`), the neck, the head; 0 where either is
    zero. A zero, random or sign-flipped gradient has cosine <= ~0 to
    the reference, whatever the rounding noise of a correct one."""
    names = sorted(n for n, label in labels.items() if label != "frozen")

    def stage(n):
        parts = n.split(".")
        return ".".join(parts[:3]) if parts[0] == "features" else parts[0]

    out = {}
    for s in sorted({stage(n) for n in names}):
        idx = [i for i, n in enumerate(names) if stage(n) == s]
        a, b = (np.concatenate([np.ravel(np.asarray(g[i], np.float64))
                                for i in idx]) for g in (grads, ref))
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        out[s] = float(a @ b / (na * nb)) if na and nb else 0.0
    return out


def bf16_step_views(runs, labels, init):
    """What a bf16 step test holds, per run of `jax_train_run` /
    `port_train_run`: {"losses", "stats", "params", "grads"} as lists of
    arrays. A JAX run's first-step gradients are its momentum less the
    weight decay (optax's trace starts at zero)."""
    names = sorted(n for n, label in labels.items() if label != "frozen")
    stats = sorted(k for k in runs[0]["params"]
                   if k.endswith(("running_mean", "running_var")))
    grads = runs[0]["grads"] if "grads" in runs[0] else {
        n: runs[0]["momentum"][n] - WEIGHT_DECAY * init[n] for n in names}
    return {"losses": [[r["metrics"][k] for k in sorted(r["metrics"])]
                       for r in runs],
            "stats": [r["params"][k] for r in runs for k in stats],
            "params": [r["params"][n] for r in runs for n in names],
            "grads": [grads[n] for n in names]}


# ---------------------------------------------------------------- PWCLite

_PWCLITE_VARIABLES = {}


def jax_pwclite_variables(n_frames=3, reduce_dense=True, h=64, w=96):
    """flax variables of `usot_tpu`'s `PWCLite(n_frames, reduce_dense)`
    without tracing its init (over a minute eagerly at 64x96): the tree
    from `jax.eval_shape`, kernels drawn lecun-normal-like (std
    sqrt(1 / fan_in)) and biases N(0, 0.1) from a numpy seed. Cached per
    configuration; callers copy before changing a leaf."""
    import jax
    import jax.numpy as jnp

    from usot_tpu.preprocessing.pwclite import PWCLite

    key = (n_frames, reduce_dense, h, w)
    if key not in _PWCLITE_VARIABLES:
        model = PWCLite(n_frames=n_frames, reduce_dense=reduce_dense)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, h, w, 3 * n_frames)))
        rng = np.random.default_rng(10 * n_frames + reduce_dense)

        def draw(path, a):
            if path[-1].key == "kernel":
                fan_in = int(np.prod(a.shape[:-1]))
                return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(
                    np.float32)
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

        _PWCLITE_VARIABLES[key] = jax.tree_util.tree_map_with_path(draw,
                                                                   shapes)
    return _PWCLITE_VARIABLES[key]
