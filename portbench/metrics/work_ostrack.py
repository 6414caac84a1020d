"""Work counts of the OSTrack cell, from shapes on the plain reference
(`reference/ostrack.py`) run on the `meta` device under `FlopCounterMode`
(`work.py`'s method; that file is the USOT cells'), at the published
kept-token counts, so the count reads the same work whatever implements
it.

* `step_flops`: one frame step of `lanes` lanes with the template's
  tokens carried (embedded once at init, as the tracker keeps them): the
  search crop's patch embedding, the 12 blocks at their token counts
  (linears, and attention's two products as the reference computes
  them), and the centre head. Two operations per multiply-add.
* `attention_bound_s`: the least time the blocks' attention cores of one
  step allow on an H100: per block the larger of their FLOPs (Q K^T and
  P V, 4 N^2 C a lane) at the bf16 peak and their bytes (q, k and v read
  once, the output written once, 2 bytes each) at 3.35 TB/s.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.metrics.work import META, PEAK_BF16, PEAK_HBM
from portbench.reference import ostrack as ref


def _sizes(items) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in items}


def frozen(sizes: dict) -> tuple:
    """`sizes` as a hashable key."""
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in sizes.items()))


@functools.lru_cache(maxsize=None)
def step_flops(sizes: tuple, lanes: int) -> float:
    s = _sizes(sizes)
    w = {k: torch.empty(sh, device=META)
         for k, sh in ref.param_shapes(s).items()}
    z = torch.empty((lanes, ref.grid(s, s["template"]) ** 2, s["dim"]),
                    device=META)
    x = torch.empty((lanes, 3, s["search"], s["search"]), device=META)
    with FlopCounterMode(display=False) as counter:
        feat, *_ = ref.backbone(z, ref.embed(x, w, "x", s), w, s)
        ref.head(feat, w)
    return float(counter.get_total_flops())


def attention_tokens(s: dict) -> list:
    """Tokens each block's attention sees: the template's and the search
    tokens left before it."""
    lens_t = ref.grid(s, s["template"]) ** 2
    n, out = ref.grid(s, s["search"]) ** 2, []
    for i in range(s["depth"]):
        out.append(lens_t + n)
        if i in s["ce_loc"]:
            n = math.ceil(s["keep"] * n)
    return out


def attention_bound_s(sizes: tuple, lanes: int) -> float:
    s = _sizes(sizes)
    c = s["dim"]
    return sum(max(4.0 * lanes * n * n * c / PEAK_BF16,
                   4.0 * lanes * n * c * 2 / PEAK_HBM)
               for n in attention_tokens(s))
