"""Benchmarks of the lockstep protocol drivers on one GPU (the counterpart
of `tools/bench_lockstep.py`).

    python -m usot_tpu_torch.tools.bench_lockstep [--vot] [--refill]
        [--batch 32] [--frames 96] [--chunk 32] [--failures 4] [--reps 3]
        [--videos 24] [--longs 2] [--device cpu] [--json PATH]
        [--ckpt PATH] [--width 64] [--channels 256]

1. --vot: the batched VOT restart protocol (`tracker/lockstep.
   run_vot_group`) at B lanes on one synthetic 480x640 video shared by
   every lane, with FORCED failures: lanes 0..failures-1 get a ground
   truth off the canvas at frame 10 + 7v (every tracker fails there) and
   a restart 5 frames later; elsewhere the ground truth is the whole
   frame (every box overlaps it). After a warm-up on the first 1 + chunk
   frames, the frame blocks are staged on the card once
   (`stage_vot_blocks`) and `--reps` timed runs reuse them
   (`staged_blocks=`): each measures the protocol, not the upload. Per
   repeat: protocol frames, restarts (code 2 rows), seconds and the
   aggregate frames/s; then their median.
2. --refill: lane refill (`run_refill_group`) against fixed padded
   groups in insertion order (`init_batch` + `track_batch`, an engine of
   the ragged size for a tail group), on a 10:1 length skew: `--videos`
   videos, `--longs` of `--frames` frames placed at the head of a
   B-group each, the rest of max(frames // 10, 8). Best of 2 each; both
   rates and the speed-up. Refill and padded tracks are compared per
   video (`box_gap_px`).

The model is bf16 (`build_usot(mem_size=4, fused_xcorr=True)`, K1 on the
card), as JAX's `load_model` builds it, on `stage_cost.load_model`'s
weights; `TrackerConfig.instance_size` is `big_sz`, as the JAX tool
sets it (a 48-px box is 0.75 % of 480x640, so a restart picks `small_sz`
and that lane spills, `spill_from`, as in JAX's run). Runs on the GPU
unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from usot_tpu_torch.tools import stage_cost as sc

BOX = 48.0
H, W = 480, 640


def synthetic_video(n_frames, h=H, w=W, seed=0, box=48):
    """The JAX tool's video: uniform noise with a yellow box moving
    (+3, +2) px per frame from (100, 120). Returns (frames, centers)."""
    rng = np.random.default_rng(seed)
    frames = np.asarray(rng.random((n_frames, h, w, 3)) * 255, np.uint8)
    centers = []
    cx, cy = 100, 120
    for f in range(n_frames):
        cx = min(cx + 3, w - box)
        cy = min(cy + 2, h - box)
        frames[f, cy - box // 2:cy + box // 2,
               cx - box // 2:cx + box // 2] = [200, 180, 60]
        centers.append((cx, cy))
    return frames, centers


def forced_failure_gts(centers, batch, failures, h=H, w=W):
    """Per lane, the ground truth of the forced-failure protocol: the box
    at frame 0 and at each restart, off the canvas at frame 10 + 7v for
    lanes v < failures, the whole frame elsewhere."""
    n = len(centers)
    gts = []
    for v in range(batch):
        fail = {10 + 7 * v} if v < failures else set()
        restarts = {f + 5 for f in fail}
        gt = []
        for f in range(n):
            cx, cy = centers[f]
            if f == 0 or f in restarts:
                gt.append([cx - BOX / 2, cy - BOX / 2, BOX, BOX])
            elif f in fail:
                gt.append([w + 50.0, h + 50.0, 20.0, 20.0])
            else:
                gt.append([0.0, 0.0, float(w), float(h)])
        gts.append(gt)
    return gts


def refill_specs(videos, longs, batch, frames, h=H, w=W):
    """The refill pool: `longs` long videos, one at the head of each
    B-group, the rest short (the first max(frames // 10, 8) frames)."""
    long_f, centers = synthetic_video(frames, h, w)
    short_f = long_f[:max(frames // 10, 8)]
    return [dict(name=f"v{i:02d}",
                 canvas=long_f if i % batch == 0 and i // batch < longs
                 else short_f,
                 h=h, w=w, init_pos=np.array(centers[0], float),
                 init_sz=np.array([BOX, BOX])) for i in range(videos)]


def config():
    from usot_tpu_torch.tracker.config import TrackerConfig

    p = TrackerConfig()
    p.instance_size = p.big_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def _engine(model, batch, max_frames, chunk, device):
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    return BatchScanEngine(model, config(), canvas_h=H, canvas_w=W,
                           batch=batch, max_frames=max_frames, chunk=chunk,
                           device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def restarts_of(results):
    return sum(sum(1 for x in r.regions if isinstance(x, int) and x == 2)
               for r in results)


def bench_vot(args, model, runner, device) -> dict:
    from usot_tpu_torch.tracker.lockstep import run_vot_group, stage_vot_blocks

    b, n = args.batch, args.frames
    frames, centers = synthetic_video(n)
    canvases = [frames] * b
    hws = [(H, W)] * b
    gts = forced_failure_gts(centers, b, args.failures)
    engine = _engine(model, b, max(256, n + 8), args.chunk, device)

    t0 = time.perf_counter()
    run_vot_group(engine, runner, [c[:1 + args.chunk] for c in canvases],
                  hws, [g[:1 + args.chunk] for g in gts], stage=True)
    _sync(device)
    warm = time.perf_counter() - t0
    print(f"vot: warm-up {warm:.1f}s", flush=True)
    t0 = time.perf_counter()
    staged = stage_vot_blocks(engine, canvases)
    mb = sum(v.numel() for v in staged.values()) / 1e6
    print(f"vot: staged {b * n} frames ({mb:.0f}MB) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    reps, results = [], None
    for r in range(args.reps):
        t0 = time.perf_counter()
        results = run_vot_group(engine, runner, canvases, hws, gts,
                                staged_blocks=staged)
        _sync(device)
        dt = time.perf_counter() - t0
        total = sum(len(res.regions) for res in results)
        n_restarts = restarts_of(results)
        reps.append({"frames": total, "restarts": n_restarts, "s": dt,
                     "fps": total / dt})
        print(f"vot rep {r}: {total} protocol frames, {n_restarts} "
              f"restarts, {dt:.2f}s -> {total / dt:.1f} fps aggregate",
              flush=True)
    med = statistics.median(x["fps"] for x in reps)
    print(f"VOT-protocol staged aggregate fps (B={b}, {args.failures} "
          f"forced restarts): median {med:.1f}", flush=True)
    return {"warmup_s": warm, "staged_mb": mb, "reps": reps,
            "median_fps": med,
            "spilled": [v for v, r in enumerate(results)
                        if r.spill_from is not None],
            "regions": [[x if x is None or isinstance(x, int)
                         else [float(y) for y in x] for x in r.regions]
                        for r in results]}


def padded_groups(engine, model, runner, specs, args, device):
    """Fixed padded groups in insertion order. Returns {name: (pos,
    sz)} as numpy."""
    b = args.batch
    out = {}
    for i in range(0, len(specs), b):
        group = specs[i:i + b]
        gb = len(group)
        geng = engine if gb == b else _engine(
            model, gb, engine.max_frames, args.chunk, device)
        state = geng.init_batch([(s["canvas"][0], s["init_pos"],
                                  s["init_sz"]) for s in group], runner)
        max_n = max(len(s["canvas"]) for s in group) - 1
        bf = np.zeros((gb, max_n, H, W, 3), np.uint8)
        nv = []
        for vi, s in enumerate(group):
            bf[vi, :len(s["canvas"]) - 1] = s["canvas"][1:]
            nv.append(len(s["canvas"]) - 1)
        _, pos, sz, _ = geng.track_batch(state, bf, n_valid=np.asarray(nv))
        for vi, s in enumerate(group):
            out[s["name"]] = (pos[vi, :nv[vi]], sz[vi, :nv[vi]])
    return out


def bench_refill(args, model, runner, device) -> dict:
    from usot_tpu_torch.tracker.lockstep import run_refill_group

    b = args.batch
    specs = refill_specs(args.videos, args.longs, b, args.frames)
    engine = _engine(model, b, max(256, args.frames + 8), args.chunk, device)
    t0 = time.perf_counter()
    run_refill_group(engine, runner, specs[:b] + specs[-2:])
    _sync(device)
    print(f"refill: warm-up {time.perf_counter() - t0:.1f}s", flush=True)
    total = sum(len(s["canvas"]) for s in specs)

    dt_refill, stats = None, {}
    for _ in range(2):  # best of 2
        t0 = time.perf_counter()
        refill = run_refill_group(engine, runner, specs, stats=stats)
        dt = time.perf_counter() - t0
        dt_refill = dt if dt_refill is None else min(dt_refill, dt)
    print(f"refill: {total} frames in {dt_refill:.2f}s -> "
          f"{total / dt_refill:.1f} fps aggregate ({stats['refills']} "
          "refills)", flush=True)
    if len(specs) % b:
        print(f"warning: {len(specs)} videos not divisible by batch {b}; "
              "the padded path builds an engine for the ragged tail group",
              flush=True)
    dt_padded = None
    for _ in range(2):
        t0 = time.perf_counter()
        padded = padded_groups(engine, model, runner, specs, args, device)
        dt = time.perf_counter() - t0
        dt_padded = dt if dt_padded is None else min(dt_padded, dt)
    print(f"padded: {total} frames in {dt_padded:.2f}s -> "
          f"{total / dt_padded:.1f} fps aggregate", flush=True)
    print(f"refill speedup on 10:1 skew: {dt_padded / dt_refill:.2f}x",
          flush=True)
    gap = max(float(np.max(np.abs(np.concatenate(
        [refill[k][0] - padded[k][0], refill[k][1] - padded[k][1]]))))
        for k in padded)
    return {"frames": total, "refill_s": dt_refill,
            "refill_fps": total / dt_refill, "refills": stats["refills"],
            "padded_s": dt_padded, "padded_fps": total / dt_padded,
            "speedup": dt_padded / dt_refill, "box_gap_px": gap,
            "finite": bool(all(np.all(np.isfinite(refill[k][0]))
                               for k in refill))}


def run(args, weights=None) -> dict:
    from usot_tpu_torch.tracker.runner import ModelRunner

    device, card = sc.open_device(args)
    model = sc.load_model(args, device, "bf16", weights)
    runner = ModelRunner(model, device=device)
    rec = {"tool": "bench_lockstep", "card": card, "device": str(device),
           "args": {k: getattr(args, k) for k in (
               "batch", "frames", "chunk", "failures", "reps", "videos",
               "longs")}}
    if args.vot:
        rec["vot"] = bench_vot(args, model, runner, device)
    if args.refill:
        rec["refill"] = bench_refill(args, model, runner, device)
    sc.write_json(args.json, rec)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vot", action="store_true")
    ap.add_argument("--refill", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--failures", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--videos", type=int, default=24,
                    help="refill: total videos in the pool")
    ap.add_argument("--longs", type=int, default=2,
                    help="refill: how many videos are full-length")
    return sc.common_args(ap).parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
