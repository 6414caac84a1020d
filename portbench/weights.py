"""Seeded weights for a configuration, made on the device, and the
one-pass BatchNorm calibration that keeps random weights finite in
bfloat16.

Conv kernels: one normal draw for all of them (a `torch.Generator` on
the device), clipped at two standard deviations and scaled per kernel
to lecun-normal's std, sqrt(1 / fan_in) / 0.8796; conv biases 0; BN
scale 1, shift `BN_SHIFT` (see there), mean 0, variance 1; the GroupDW
scale weights 1, the bbox head's `adjust` 0.1 and `bias` 1. Calibration (`calibrate`) runs
the reference network once with every BatchNorm in "set" mode on the
cell's own init crops (templates, search crops, and memory kernels
pooled from the search features at the target), so each BN normalises
what reaches it on that traffic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.net import Net, param_shapes, prpool

LECUN_TRUNC = 0.87962566103423978
# BN shift: a ReLU after a BN of shift 0 zeroes half of its inputs, and a
# random BN-ReLU network then multiplies a small error by ~1.47 a layer
# (the per-channel mean the next BN removes), some 10^4 over this
# network's depth: no precision could be told from another on its
# outputs. At shift 2 a ReLU passes ~98 % and the factor is ~1.02.
BN_SHIFT = 2.0


def make_weights(seed: int, width: int, channels: int, device) -> dict:
    """{name: float32 tensor on `device`} in the released layout."""
    shapes = param_shapes(width, channels)
    gen = torch.Generator(device=device).manual_seed(seed)
    kernels = [k for k, s in shapes.items()
               if len(s) == 4 and k.endswith(".weight")]
    total = sum(math.prod(shapes[k]) for k in kernels)
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    w, at = {}, 0
    for k in kernels:
        s = shapes[k]
        n = math.prod(s)
        std = math.sqrt(1.0 / (s[1] * s[2] * s[3])) / LECUN_TRUNC
        w[k] = (draw[at:at + n] * std).reshape(s)
        at += n
    for k, s in shapes.items():
        if k not in w:
            w[k] = torch.full(s, _fill(k, shapes), device=device)
    return {k: w[k] for k in shapes}


def _fill(name: str, shapes: dict) -> float:
    if name.endswith("adjust"):
        return 0.1
    if name.endswith(("running_var", ".weight")) \
            or name == "connect_model.bias":
        return 1.0  # BN scales and variances, GroupDW weights, bbox bias
    if name.endswith(".bias") and name[:-4] + "running_mean" in shapes:
        return BN_SHIFT
    return 0.0


@torch.no_grad()
def calibrate(weights: dict, crops: dict, queue: int = 7) -> dict:
    """Sets every BN's running statistics in `weights` (in place) from one
    pass of the reference network over a cell's own init crops: `crops`
    holds float32 tensors on the weights' device, templates `z` (N, 127,
    127, 3) with their boxes `tb` (N, 4) on the template feature axis,
    search crops `x` (N, 255, 255, 3) with their boxes `sb` (N, 4) on the
    search feature axis. The memory head sees each lane's pooled target
    as all `queue` kernels."""
    net = Net(weights, mode="set")
    xf = net.features(crops["x"])
    net.mode = "eval"
    zf = net.template(crops["z"], crops["tb"])
    mem = prpool(xf, crops["sb"])
    net.mode = "set"
    cls_x = net.encode(xf, "cls", "s")
    net.offline(net.encode(zf, "cls", "k"), net.encode(zf, "reg", "k"),
                cls_x, net.encode(xf, "reg", "s"))
    net.mode = "eval"
    mem = net.encode(mem, "cls", "k")
    net.mode = "set"
    net.memory(cls_x, [torch.repeat_interleave(e, queue, dim=0)
                       for e in mem], queue)
    return weights


def tracking_weights(seed: int, config: dict, first: list, pos, sz,
                     device) -> dict:
    """A tracking cell's weights: `make_weights` at the configuration's
    widths, calibrated on the reference's init crops of the cell's first
    frames (`first`: (H, W, 3) uint8 numpy; pos, sz: (N, 2))."""
    from portbench.reference.tracker import Tracker

    w = make_weights(seed, config["width"], config["channels"], device)
    tracker = Tracker(Net(w), config["tracker"])
    crops = [tracker.init_crops(im, p, s) for im, p, s in zip(first, pos, sz)]

    def stack(key):
        return torch.as_tensor(np.stack([c[key] for c in crops]),
                               dtype=torch.float32, device=device)
    return calibrate(w, {k: stack(k) for k in ("z", "tb", "x", "sb")})
