"""Device-time A/B of the pairwise depthwise-correlation routes at the
engine's hot shapes on one GPU (counterpart of `tools/bench_xcorr.py`):
the plain broadcast shift-multiply, the grouped convolution (F.conv2d,
groups B*C) and the hand-written kernel K3.

Shapes: offline head (B, 29, 29, C) x (B, 5, 5, C); memory head
(7B, 29, 29, C) x (7B, 5, 5, C); C = 256.

    python -m usot_tpu_torch.tools.bench_xcorr [--batch 32] [--iters 30]
                                               [--dtype bf16|f32]
                                               [--json PATH]

Prints one line per route (device ms per call from CUDA events over
CUDA-graph replays) and, last, a JSON list of the records (`--json PATH`
writes them with the card's line). Needs a GPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from usot_tpu_torch.core.device import f32_numerics, resolve_device
from usot_tpu_torch.ops.xcorr_kernel import launch_counts
from usot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                      xcorr_depthwise_pairwise,
                                      xcorr_depthwise_pairwise_reference)
from usot_tpu_torch.tools.timing import card_line, time_device_ms

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
INNER = 10  # calls per CUDA graph in `time_device_ms`


def stages(batch: int, dtype, device, channels: int = 256, seed: int = 0):
    """[(label, fn of no arguments)] for both heads and all routes, on
    seeded inputs on `device`."""
    rng = np.random.default_rng(seed)
    out = []
    for b, tag in ((batch, "offline"), (7 * batch, "memory")):
        x = torch.from_numpy(rng.normal(size=(b, 29, 29, channels))
                             .astype(np.float32)).to(device, dtype)
        k = torch.from_numpy(rng.normal(size=(b, 5, 5, channels))
                             .astype(np.float32)).to(device, dtype)
        shape = f"x ({b}, 29, 29, {channels}), k ({b}, 5, 5, {channels})"
        out += [
            (f"shift-multiply (plain) [{tag}] {shape}",
             lambda x=x, k=k: xcorr_depthwise_pairwise_reference(x, k)),
            (f"grouped conv B*C={b * channels} [{tag}] {shape}",
             lambda x=x, k=k: xcorr_depthwise(x, k)),
            (f"K3 kernel [{tag}] {shape}",
             lambda x=x, k=k: xcorr_depthwise_pairwise(x, k)),
        ]
    return out


def run(stage_list, iters: int) -> list:
    """Times each stage; records its device ms, the kernel wrappers'
    counts (`wrapper_calls`: 3 warm-up and INNER captured calls of the
    stage) and the launches the device ran (`device_launches`: the
    warm-up calls' and those of the 3 + iters graph replays)."""
    records = []
    for label, fn in stage_list:
        before = launch_counts()
        ms = time_device_ms(fn, inner=INNER, reps=iters)
        after = launch_counts()
        calls = {k: after[k] - before[k] for k in after}
        per_call = {k: n // (3 + INNER) for k, n in calls.items()}
        rec = {"stage": label, "ms": ms, "wrapper_calls": calls,
               "device_launches": {k: n * (3 + INNER * (3 + iters))
                                   for k, n in per_call.items()}}
        print(f"{label:72s} {ms:9.4f} ms/call", flush=True)
        records.append(rec)
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--json", default=None,
                    help="write the records, with the card, to this path")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    f32_numerics()
    card = card_line()
    print(f"{torch.cuda.get_device_name(device)}; {card}; "
          f"dtype {args.dtype}", flush=True)
    records = run(stages(args.batch, DTYPES[args.dtype], device),
                  args.iters)
    print(json.dumps(records), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"tool": "bench_xcorr", "card": card,
                       "batch": args.batch, "dtype": args.dtype,
                       "records": records}, f, indent=1)
    return records


if __name__ == "__main__":
    main()
