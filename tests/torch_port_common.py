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
