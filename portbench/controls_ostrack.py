"""The controls of the OSTrack cell's check (`controls.py`'s, for the
cell driver `engine_staged_ostrack`, which `controls.py` does not take):

* `fp8`, the reference in the next precision down: its blocks' linear
  layers with inputs and weights rounded through float8 e4m3 (a
  per-tensor scale, `controls.fp8`) runs the check's lanes free over one
  round; the float32 reference then follows its outputs (its CE sets
  too) as it follows the program's (`ce_tokens_off` is the program's
  counter: 0 here);
* the program itself, one round long: `sound`, or with one of
  `faults_ostrack.py`'s faults planted.

    python3 -m portbench.controls_ostrack --workload <cell> --seeds <n>
        [<n>...] [--variant fp8|sound|<fault>]

prints one JSON line per seed with the numbers the cell's check compares
(on the card; the tests run it at small sizes on the CPU).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench.checks import STATS, spread
from portbench.controls import fp8
from portbench.faults import Patcher
from portbench.faults_ostrack import OSTRACK
from portbench.reference import ostrack as ref


def fp8_reference(ctx) -> dict:
    """The fp8 reference free on the cell's check lanes over one round,
    judged by the float32 reference: each reading's statistics."""
    from portbench.videos import make_videos
    from portbench.weights_ostrack import tracking_weights

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    lanes = tr["lanes"]
    video, pos0, sz0 = make_videos(ctx.seed, lanes, tr["frames_per_video"],
                                   *tr["canvas"], tr["box_px"],
                                   tr["speed_px"], dev)
    first = [video[0, i].cpu().numpy() for i in range(lanes)]
    boxes = np.concatenate([pos0 - sz0 / 2, sz0], axis=1)
    weights = tracking_weights(ctx.seed, cfg, first, boxes, dev)
    rng = np.random.default_rng([ctx.seed, 1])  # engine_staged_ostrack's lanes
    sample = np.sort(rng.choice(lanes, tr["check_lanes"], replace=False))
    frames = [video[:, int(i)].cpu().numpy() for i in sample]
    del video
    with torch.no_grad():
        out = ref.Tracker(weights, cfg["sizes"], q=fp8).track(frames,
                                                              boxes[sample])
        _, readings = ref.Tracker(weights, cfg["sizes"]).track(
            frames, boxes[sample], forced=out)
    print(spread(readings), file=sys.stderr, flush=True)
    numbers = {f"{k}_{s}": float(f(v)) for k, v in readings.items()
               for s, f in STATS.items()}
    return dict(numbers, ce_tokens_off=0.0)


def program_run(ctx, variant: str) -> dict:
    """The cell's own run, one round long, sound or with fault `variant`
    planted: every number its check compares."""
    driver = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")
    with Patcher() as patch:
        if variant != "sound":
            OSTRACK[variant](patch)
        out = driver.run(ctx)
    for note in out.notes:
        print(note, file=sys.stderr, flush=True)
    return {k: v for k, (v, _) in out.checks.items()}


def run(ctx, variant: str | None = None) -> dict:
    variant = variant or ctx.config["control"]
    if variant == "fp8":
        return fp8_reference(ctx)
    return program_run(ctx, variant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Controls of the OSTrack "
                                 "cell's check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default=None,
                    choices=("fp8", "sound", *OSTRACK))
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    _, cell, config, traffic = harness.find_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("portbench.controls_ostrack: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        ctx = harness.Context(root=root, cell=cell, config=config,
                              traffic=traffic, seed=seed, seconds=0.0,
                              trace=False, device=torch.device("cuda", 0),
                              started=time.time())
        t0 = time.perf_counter()
        numbers = run(ctx, args.variant)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant or config["control"],
                          **numbers, "seconds": time.perf_counter() - t0}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
