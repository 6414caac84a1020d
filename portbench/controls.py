"""The controls of the comparisons that decide `correct`: each puts a
deliberately worse computation in the program's place, on a cell's own
inputs and sizes, and reads the numbers the cell's check compares. A
limit lies between the program's readings (its sound runs) and these.

* Tracking cells (bf16): the reference in the next precision down, fp8
  (e4m3 with a per-tensor scale; every convolution's and correlation's
  operands and result and every BN's output rounded), runs the check's
  lanes (or videos) free, as the program would; the float32 reference then follows its outputs as it
  follows the program's.
* The training cell (float32, TF32 off): the reference with TF32 on, and
  the fault of half the batch left out (the mean taken over the rest),
  each against the float32 reference.
* The mining cell (float32, TF32 off): the program with TF32 on in its
  flow network's forwards (`flow_tf32`), the plain reference judging it
  as it judges the program.
* The program itself, on any cell, one round (one video) long: sound
  (`sound`), or with one of `faults.py`'s faults planted (the fault's
  name); the numbers are the cell's own check's.

    python3 -m portbench.controls --workload <cell> --seeds <n> [<n>...]
        [--variant fp8|tf32|half_batch|flow_tf32|sound|<fault>]

prints one JSON line per seed with the numbers (on the card; the tests
run it at small sizes on the CPU). The variant defaults to the cell's
control, which its configuration names (`control`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench.checks import train_numbers
from portbench.faults import MINING, TRACKING
from portbench.reference.net import Net
from portbench.reference.numerics import deterministic
from portbench.reference.tracker import Tracker

FP8_MAX = 448.0  # largest float8_e4m3fn


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to the
    format's largest), returned in x's dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _most(readings: dict) -> dict:
    """Each reading's mean, 99th percentile and largest (the statistics a
    limit may name), and its spread for the log."""
    from portbench.checks import STATS, spread

    print(spread(readings), file=sys.stderr, flush=True)
    return {f"{k}_{s}": float(f(v)) for k, v in readings.items()
            for s, f in STATS.items()}


def track_staged(ctx) -> dict:
    """fp8 reference on the staged cell's check lanes (the driver's draw)
    over one round, judged by the float32 reference."""
    from portbench.videos import make_videos
    from portbench.weights import tracking_weights

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    video, pos0, sz0 = make_videos(ctx.seed, tr["lanes"],
                                   tr["frames_per_video"], *tr["canvas"],
                                   tr["box_px"], tr["speed_px"], dev)
    first = [video[0, i].cpu().numpy() for i in range(tr["lanes"])]
    weights = tracking_weights(ctx.seed, cfg, first, pos0, sz0, dev)
    rng = np.random.default_rng([ctx.seed, 1])  # the driver's lanes
    sample = np.sort(rng.choice(tr["lanes"], tr["check_lanes"],
                                replace=False))
    frames = video[:, torch.as_tensor(sample, device=dev)].transpose(0, 1) \
        .contiguous()
    del video
    init = [(pos0[i], sz0[i]) for i in sample]
    with torch.no_grad():
        out = Tracker(Net(weights, q=fp8), cfg["tracker"]).track(frames, init)
        _, readings = Tracker(Net(weights), cfg["tracker"]).track(
            frames, init, forced=out)
    return _most(readings)


def track_live(ctx) -> dict:
    """fp8 reference over the live cell's videos (their first
    `check_frames` frames or more, the longest first), judged by the
    float32 reference with the host crop."""
    from portbench.drivers.tracker_live import host_videos
    from portbench.weights import tracking_weights

    cfg, dev = ctx.config, ctx.device
    videos = host_videos(ctx.seed, ctx.traffic, dev)
    weights = tracking_weights(ctx.seed, cfg, [v[0][0] for v in videos],
                               [v[1] for v in videos],
                               [v[2] for v in videos], dev)
    readings, total = {}, 0
    with torch.no_grad():
        for frames, pos, sz in sorted(videos, key=lambda v: -len(v[0])):
            if total >= ctx.traffic["check_frames"]:
                break
            out = Tracker(Net(weights, q=fp8), cfg["tracker"]).track(
                [frames], [(pos, sz)], crop="host")
            _, r = Tracker(Net(weights), cfg["tracker"]).track(
                [frames], [(pos, sz)], forced=out, crop="host")
            for k, v in r.items():
                readings.setdefault(k, []).append(v.ravel())
            total += len(frames) - 1
    return _most({k: np.concatenate(v) for k, v in readings.items()})


def train_cycle(ctx, variant: str) -> dict:
    """The float32 reference's first steps against the same steps with
    TF32 on (`tf32`) or on the first half of each batch (`half_batch`)."""
    from portbench.drivers.train_step import hyper, make_batches
    from portbench.reference.train import train
    from portbench.weights import make_weights

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    weights = make_weights(ctx.seed, cfg["width"], cfg["channels"], dev)
    batches = make_batches(ctx.seed, tr, dev)
    hp, steps = hyper(cfg, tr), tr["check_steps"]

    def flat(run):
        return {"loss": [l[3] for l in run["loss"]],
                **{k: {n: t.cpu() for n, t in run[k].items()}
                   for k in ("grad1", "params", "stats")}}
    with deterministic():
        ref = flat(train(weights, batches, hp, steps))
    if variant == "tf32":
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            worse = flat(train(weights, batches, hp, steps))
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    elif variant == "half_batch":
        half = [{k: v[:tr["batch"] // 2] for k, v in b.items()}
                for b in batches]
        with deterministic():
            worse = flat(train(weights, half, hp, steps))
    else:
        raise ValueError(f"variant {variant!r}")
    numbers = train_numbers(worse, ref, {k: v.cpu()
                                         for k, v in weights.items()})
    return {k: v for k, (v, _) in numbers.items()}


def flow_tf32(patch):
    """The mining program's flow forwards with TF32 on (cuDNN and
    matmul), the switches restored after each."""
    from usot_tpu_torch.preprocessing.inference import FlowHelper

    real = FlowHelper.forward

    def forward(self, *a, **k):
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return real(self, *a, **k)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
    patch.setattr(FlowHelper, "forward", forward)


# the reference put in the program's place, by variant and by driver
REFERENCE = {
    "fp8": {"engine_staged": track_staged, "tracker_live": track_live},
    "tf32": {"train_step": lambda ctx: train_cycle(ctx, "tf32")},
    "half_batch": {"train_step": lambda ctx: train_cycle(ctx, "half_batch")},
}
# the program with a lower precision switched on or a fault planted
PROGRAM = {"flow_tf32": flow_tf32, **TRACKING, **MINING}


def program_run(ctx, variant: str) -> dict:
    """The cell's own run, one round long, sound or with `variant`
    planted (a fault, or the mining cell's `flow_tf32` control): every
    number its check compares, the readings on the log."""
    import importlib

    from portbench.faults import Patcher

    driver = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")
    with Patcher() as patch:
        if variant != "sound":
            PROGRAM[variant](patch)
        out = driver.run(ctx)
    for note in out.notes:
        print(note, file=sys.stderr, flush=True)
    return {k: v for k, (v, _) in out.checks.items()}


def run(ctx, variant: str | None = None) -> dict:
    """The numbers of `variant` (by default the configuration's
    `control`) on the cell."""
    variant = variant or ctx.config["control"]
    if variant == "sound" or variant in PROGRAM:
        return program_run(ctx, variant)
    return REFERENCE[variant][ctx.traffic["driver"]](ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Controls of a cell's check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default=None,
                    choices=("sound", *REFERENCE, *PROGRAM))
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    _, cell, config, traffic = harness.find_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA device", file=sys.stderr)
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
        variant = args.variant or config["control"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": variant, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
