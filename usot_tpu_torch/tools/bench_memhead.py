"""Sub-stage device times of the online memory head at engine shapes on
one GPU (counterpart of `tools/bench_memhead.py`).

Stages (B=32 videos, M=7 queue kernels, C=256, 29x29 search encodings,
5x5 kernels): queue re-encode (3 convs on B*M 7x7 maps); the
correlation of the search encodings against the queue, as a repeat to
B*M lanes + 3 pairwise correlations (plain, grouped conv, K3), as 3
multi-kernel correlations (plain, K2), and as the fused 3-scale GroupDW
(K1, M=7 and M=1); ConfFusion (2 convs + normalise); the memory tower
(4 convs). Standalone replicas with random weights: timing only, the
real modules are tested elsewhere.

    python -m usot_tpu_torch.tools.bench_memhead [--batch 32] [--iters 30]
                                                 [--dtype bf16|f32]

Prints one line per stage (device ms per call from CUDA events over
CUDA-graph replays) and, last, a JSON list of the records. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from usot_tpu_torch.core.device import f32_numerics, resolve_device
from usot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                      xcorr_depthwise_multi,
                                      xcorr_depthwise_multi_reference,
                                      xcorr_depthwise_pairwise,
                                      xcorr_depthwise_pairwise_reference,
                                      xcorr_groupdw)
from usot_tpu_torch.tools.bench_xcorr import DTYPES, run
from usot_tpu_torch.tools.timing import card_line

M = 7


def stages(batch: int, dtype, device, channels: int = 256, seed: int = 0):
    """[(label, fn of no arguments)] of the memory head's sub-stages, on
    seeded inputs on `device`."""
    rng = np.random.default_rng(seed)
    c, bm = channels, batch * M

    def t(*shape, scale=1.0):
        a = rng.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(device, dtype)

    queue = t(bm, c, 7, 7)                                  # NCHW
    cls_x = [t(batch, 29, 29, c) for _ in range(3)]         # NHWC
    w_enc = [t(c, c, 3, 3, scale=0.05) for _ in range(3)]
    w_cf = [t(c, c, 3, 3, scale=0.05) for _ in range(2)]
    w_tow = [t(c, c, 3, 3, scale=0.05) for _ in range(4)]
    dw = t(bm, c, 25, 25)
    zs = [t(bm, 5, 5, c) for _ in range(3)]
    zs_bm = [z.reshape(batch, M, 5, 5, c) for z in zs]
    fused = t(batch, c, 25, 25)
    xs3 = [t(batch, 29, 29, c), t(batch, 27, 29, c), t(batch, 29, 27, c)]
    ks3 = [t(batch, M, 5, 5, c), t(batch, M, 3, 5, c), t(batch, M, 5, 3, c)]
    ks3_1 = [k[:, :1].contiguous() for k in ks3]

    def encode():
        return [F.relu(F.conv2d(queue, w)) for w in w_enc]

    def repeat_xcorr(route):
        def fn():
            acc = 0.0
            for x, k in zip(cls_x, zs):
                acc = acc + route(torch.repeat_interleave(x, M, dim=0), k)
            return acc
        return fn

    def multi_xcorr(route):
        def fn():
            return [route(x, k) for x, k in zip(cls_x, zs_bm)]
        return fn

    def conffusion():
        conf = torch.clamp(F.relu(F.conv2d(dw, w_cf[0], padding=1)),
                           -6.0, 4.0)
        conf = torch.exp(conf).reshape(batch, M, c, 25, 25)
        conf = conf / torch.sum(conf, dim=1, keepdim=True)
        value = F.relu(F.conv2d(dw, w_cf[1], padding=1))
        return torch.sum(conf * value.reshape(batch, M, c, 25, 25), dim=1)

    def tower():
        x = fused
        for w in w_tow:
            x = F.relu(F.conv2d(x, w, padding=1))
        return x

    return [
        ("queue re-encode (3 convs, B*M)", encode),
        ("repeat + 3x xcorr, plain (B*M lanes)",
         repeat_xcorr(xcorr_depthwise_pairwise_reference)),
        ("repeat + 3x xcorr, grouped conv (B*M lanes)",
         repeat_xcorr(xcorr_depthwise)),
        ("repeat + 3x xcorr, K3 (B*M lanes)",
         repeat_xcorr(xcorr_depthwise_pairwise)),
        ("3x multi-xcorr, plain", multi_xcorr(xcorr_depthwise_multi_reference)),
        ("3x multi-xcorr, K2", multi_xcorr(xcorr_depthwise_multi)),
        ("GroupDW fused, K1 (M=7)", lambda: xcorr_groupdw(xs3, ks3)),
        ("GroupDW fused, K1 (M=1)", lambda: xcorr_groupdw(xs3, ks3_1)),
        ("ConfFusion (2 convs + normalise)", conffusion),
        ("memory tower (4 convs, B)", tower),
    ]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    f32_numerics()
    print(f"{torch.cuda.get_device_name(device)}; {card_line()}; "
          f"dtype {args.dtype}, B={args.batch}, M={M}", flush=True)
    records = run(stages(args.batch, DTYPES[args.dtype], device),
                  args.iters)
    print(json.dumps(records), flush=True)
    return records


if __name__ == "__main__":
    main()
