"""Seeded OSTrack weights for a configuration, made on the device, and the
one-pass calibration of the centre head's BatchNorms.

One normal draw (a `torch.Generator` on the device), clipped at two
standard deviations, for every kernel and position table:

* linear, patch-embedding and conv kernels at lecun-normal's std,
  sqrt(1 / fan_in) / 0.8796; the rows of `attn.qkv` that make queries
  and keys times the configuration's `qk_gain`, so the attention's
  logits spread by about qk_gain^2 instead of 1 and candidate
  elimination ranks tokens by more than rounding (`assumed`);
* the position tables `pos_embed_z` / `pos_embed_x` at `pos_std`, the
  patch tokens' own scale, so positions matter;
* the head's last 1x1 convs times `head_gain` per branch, their biases
  `head_bias` (the size branch's at logit(0.2): a box about its crop's
  fifth, as the search factor 5 makes it);
* LayerNorms at identity, other biases 0, BN scale 1 and shift 0.

`calibrate` then sets every head BN's statistics from one pass of the
reference over the cell's own init crops (templates and search crops at
the init boxes), so each BN normalises what reaches it on that traffic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import ostrack as ref

LECUN_TRUNC = 0.87962566103423978


def make_weights(seed: int, config: dict, device) -> dict:
    """{name: float32 tensor on `device`} in OSTrack's layout."""
    s, wc = config["sizes"], config["weights"]
    shapes = ref.param_shapes(s)
    drawn = [k for k, sh in shapes.items()
             if (len(sh) >= 2 and k.endswith(".weight")) or "pos_embed" in k]
    total = sum(math.prod(shapes[k]) for k in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    w, at = {}, 0
    for k in drawn:
        sh = shapes[k]
        n = math.prod(sh)
        if "pos_embed" in k:
            std = wc["pos_std"] / LECUN_TRUNC
        else:
            std = math.sqrt(1.0 / math.prod(sh[1:])) / LECUN_TRUNC
        w[k] = (draw[at:at + n] * std).reshape(sh)
        at += n
        if k.endswith("attn.qkv.weight"):
            w[k][:2 * s["dim"]] *= wc["qk_gain"]
        for branch, gain in wc["head_gain"].items():
            if k == f"box_head.conv5_{branch}.weight":
                w[k] *= gain
    for k, sh in shapes.items():
        if k in w:
            continue
        fill = 1.0 if k.endswith(("running_var", ".weight")) else 0.0
        for branch, bias in wc["head_bias"].items():
            if k == f"box_head.conv5_{branch}.bias":
                fill = bias
        w[k] = torch.full(sh, fill, device=device)
    return {k: w[k] for k in shapes}


@torch.no_grad()
def calibrate(weights: dict, config: dict, first: list, boxes) -> dict:
    """Sets the head's BN statistics in `weights` (in place) from the
    reference's forward over the lanes' init crops: `first` the first
    frames (h, w, 3) uint8, `boxes` (N, 4) [x, y, w, h]. Returns the
    weights."""
    s = config["sizes"]
    device = next(iter(weights.values())).device
    z = np.stack([ref.sample_target(im, b, s["template_factor"],
                                    s["template"])[0]
                  for im, b in zip(first, boxes)])
    x = np.stack([ref.sample_target(im, b, s["search_factor"],
                                    s["search"])[0]
                  for im, b in zip(first, boxes)])
    ref.forward(ref.normalise(z, device), ref.normalise(x, device), weights,
                s, calibrate=True)
    return weights


def tracking_weights(seed: int, config: dict, first: list, boxes,
                     device) -> dict:
    """The cell's weights: `make_weights`, then `calibrate` on the init
    crops of its first frames."""
    return calibrate(make_weights(seed, config, device), config, first,
                     boxes)
