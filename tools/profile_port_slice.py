#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch port, on one GPU.

    python3 tools/profile_port_slice.py [--frames 30] [--box 48]

Builds the full-width model as `chip_smoke.py` does (width 64, channels
256, queue 7, random seeded weights, calibrated BN stats, fused GroupDW
kernel), tracks one synthetic 480x640 video (a 48-px box gives instance
255, a 16-px box instance 271) and prints one JSON line:

* `stages_ms`: median host-clock time per frame of each stage of
  `USOTTracker.track` (crop, search features, heads + copy to host,
  postprocess, memory pooling, the rest), each stage ended by a
  `torch.cuda.synchronize()` so device work is charged to its stage;
* `profile`: a `torch.profiler` window over further frames without the
  extra synchronizes: wall ms per frame, device busy ms per frame (sum of
  kernel durations), device idle share, kernel launches per frame and
  the kernels with the most device time.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (TF32 off, synthetic_video)
import usot_tpu_torch.tracker.tracker as tracker_mod  # noqa: E402
from usot_tpu_torch.models.calibrate import calibrate_batch_stats  # noqa: E402
from usot_tpu_torch.models.usot import build_usot, init_model  # noqa: E402
from usot_tpu_torch.tracker.runner import ModelRunner  # noqa: E402
from usot_tpu_torch.tracker.tracker import USOTTracker  # noqa: E402


class StageClock:
    """Wraps callables so that each call's time, device work included,
    is added to a named stage of the current frame."""

    def __init__(self):
        self.frame = defaultdict(float)
        self.frames = []
        self.on = False

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.frame[name] += (time.perf_counter() - t0) * 1e3
            return out
        return timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--box", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_slice: no CUDA device", file=sys.stderr)
        return 1

    model = build_usot(mem_size=7, fused_xcorr=True)
    init_model(model, torch.Generator().manual_seed(0), device="cuda")
    calibrate_batch_stats(model, n_iter=10)
    runner = ModelRunner(model, device="cuda")
    frames, centers = chip_smoke.synthetic_video(2 * args.frames + 1,
                                                 args.box)

    clock = StageClock()
    tracker_mod.get_subwindow = clock.wrap("crop", tracker_mod.get_subwindow)
    tracker_mod.postprocess_response = clock.wrap(
        "postprocess", tracker_mod.postprocess_response)
    for name, stage in (("search_features", "search_features"),
                        ("track_memory", "heads_and_copy"),
                        ("extract_memory_feature", "memory_pool")):
        setattr(runner, name, clock.wrap(stage, getattr(runner, name)))

    tracker = USOTTracker()
    st = tracker.init(frames[0], np.array(centers[0], np.float64),
                      np.array([args.box, args.box], np.float64), runner)
    clock.on = True
    for im in frames[1:args.frames + 1]:
        clock.frame = defaultdict(float)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tracker.track(st, im)
        total = (time.perf_counter() - t0) * 1e3
        clock.frame["rest"] = total - sum(clock.frame.values())
        clock.frame["total"] = total
        clock.frames.append(dict(clock.frame))
    clock.on = False
    stages = {k: statistics.median(f[k] for f in clock.frames)
              for k in clock.frames[0]}

    window = frames[args.frames + 1:]
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for im in window:
            st = tracker.track(st, im)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    n = len(window)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "card": chip_smoke.card_line(),
        "instance": st["p"].instance_size, "frames_staged": len(clock.frames),
        "stages_ms": stages,
        "profile": {
            "frames": n, "wall_ms_per_frame": wall / n,
            "device_busy_ms_per_frame": busy / n if kernels else None,
            "device_idle_share": 1 - busy / wall if kernels else None,
            "kernels_per_frame": len(kernels) / n,
            "top_kernels_ms_per_frame": [[k[:90], v / n] for k, v in top],
        },
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
