"""The bfloat16 batch-engine step with and without the layers' card-only
paths, alternating in one process, on one GPU.

    python -m usot_tpu_torch.tools.ab_card_layers

Two paths of `models/layers.py` run only on a CUDA tensor in a
narrower dtype than the parameters:

* eval-mode `BatchNorm`: `batch_norm_elemt` with the per-channel
  `rsqrt(var + eps)` kept, one launch (the plain side: `F.batch_norm`
  on the mixed dtypes, which computes the `rsqrt` anew in a launch of
  its own every call);
* `Conv2d`: the cast kernel kept in channels-last for channels-last
  input (the plain side: the kept contiguous cast, which torch converts
  to channels-last at every call).

`BatchScanEngine` at `profile_engine`'s configuration (480x640, instance
255, full width, seeded weights, B=32) in bfloat16 tracks 128 staged
frames per reading (two chunks of 64), after a warm chunk on the side
it switches to. The sides alternate plain, kept, kept, plain, ... over
six readings each. Prints each reading, then one JSON line:
ms per frame step (host clock, ending in a synchronize) of every
reading and their median per side, with the card's name and power
limit. Needs a GPU.
"""
from __future__ import annotations

import json
import statistics
import time

import torch
import torch.nn as nn
import torch.nn.functional as F

from usot_tpu_torch.models import layers
from usot_tpu_torch.tools.profile_engine import staged_engine
from usot_tpu_torch.tools.timing import card_line

KEPT = {"bn": layers.BatchNorm.forward, "conv": layers.Conv2d.forward}
BATCH, CHUNK, PAIRS = 32, 64, 6


def plain_bn(self, x, train: bool = False):
    """`layers.BatchNorm.forward` with `F.batch_norm` in eval mode on every
    device."""
    if train:
        return KEPT["bn"](self, x, train)
    return F.batch_norm(x, self.running_mean, self.running_var,
                        self.weight, self.bias, False, 0.0, self.eps)


def plain_conv(self, x):
    """`layers.Conv2d.forward` with the contiguous cast kernel for every
    input layout."""
    if x.dtype == self.weight.dtype:
        return nn.Conv2d.forward(self, x)
    y = self._conv_forward(x, layers.cast_param(self, "weight", x.dtype),
                           None)
    if self.bias is None:
        return y
    return y + layers.cast_param(self, "bias", x.dtype)[:, None, None]


def use(side: str):
    plain = side == "plain"
    layers.BatchNorm.forward = plain_bn if plain else KEPT["bn"]
    layers.Conv2d.forward = plain_conv if plain else KEPT["conv"]


def main() -> dict:
    engine, state, staged = staged_engine(BATCH, CHUNK, False,
                                          torch.bfloat16)
    steps = 2 * CHUNK
    order = [("plain", "kept", "kept", "plain")[i % 4]
             for i in range(2 * PAIRS)]
    readings = {"plain": [], "kept": []}
    try:
        for side in order:
            use(side)
            state, *_ = engine.track_staged(state, staged[:1])  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, *_ = engine.track_staged(state, staged)
            torch.cuda.synchronize()
            readings[side].append((time.perf_counter() - t0) / steps * 1e3)
            print(side, readings[side][-1], flush=True)
    finally:
        use("kept")
    out = {"card": card_line(), "engine": "BatchScanEngine",
           "dtype": "torch.bfloat16", "batch": BATCH,
           "steps_per_reading": steps, "order": order,
           "ms_per_step": readings,
           "median_ms_per_step": {k: statistics.median(v)
                                  for k, v in readings.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
