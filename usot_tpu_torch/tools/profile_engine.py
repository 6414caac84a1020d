"""Where a frame step's time goes in the port's batch engine, on one GPU.

    python -m usot_tpu_torch.tools.profile_engine [--batch 32]
                                                  [--frames 16]
                                                  [--fused-head]
                                                  [--dtype bfloat16]

`BatchScanEngine` at `bench.py`'s configuration (480x640, instance 255,
the triangle-wave video on every lane, frames staged on the card) with
the full-width model `chip_smoke.py` builds (width 64, channels 256,
queue 7, random seeded weights, BN stats calibrated by 10 passes in
float32, K1 for the correlations), in `--dtype` (float32 with TF32 off,
or bfloat16 over the same float32 weights). After init, a warm chunk of
`--frames` steps (during which `FlopCounterMode` counts the aten ops'
FLOPs from their shapes;
the hand-written kernels are not aten ops), then one staged chunk under
`torch.profiler`. Prints one JSON line: frames/s, aten GFLOP per step,
and per step the wall and device-busy ms, the device idle share, the
kernel launches (in all and by kernel), K1's device ms and the kernels
with the most device time. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from usot_tpu_torch.core.device import f32_numerics, resolve_device
from usot_tpu_torch.models.calibrate import calibrate_batch_stats
from usot_tpu_torch.models.usot import build_usot, init_model
from usot_tpu_torch.tools.timing import card_line
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.engine import BatchScanEngine, synthetic_video
from usot_tpu_torch.tracker.runner import ModelRunner

# K1 is the 3-scale instantiation of the tiled kernel (csrc/xcorr_tile.cuh)
K1_KERNEL = re.compile(r"xcorr_tile_kernel<[^>]*, 3>")


def device_profile(run, n_steps: int) -> dict:
    """`torch.profiler` over `run()` (which must end in a synchronize):
    per step the wall and device-busy ms, the idle share, the kernel
    launches, K1's device ms and the kernels with the most device
    time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, count = defaultdict(float), defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        count[e.name] += 1
    busy = sum(by_name.values())
    n = n_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "steps": n, "wall_ms_per_step": wall / n,
        "device_busy_ms_per_step": busy / n if kernels else None,
        "device_idle_share": 1 - busy / wall if kernels else None,
        "kernels_per_step": len(kernels) / n,
        "k1_ms_per_step": sum(v for k, v in by_name.items()
                              if K1_KERNEL.search(k)) / n,
        "top_kernels_ms_per_step": [[k[:90], v / n] for k, v in top],
        "launches_per_step_by_kernel": [
            [k[:90], c / n] for k, c in sorted(count.items(),
                                               key=lambda kv: -kv[1])[:25]],
    }


def staged_engine(batch: int, n: int, fused_head: bool,
                  dtype: torch.dtype = torch.float32):
    """The engine of the module note on the GPU, its state after init,
    and `2 * n` frames per lane staged on the card in chunks of `n`.
    Returns (engine, state, staged)."""
    device = resolve_device(None)
    model = build_usot(mem_size=7, fused_xcorr=True)
    init_model(model, torch.Generator().manual_seed(0), device=device)
    calibrate_batch_stats(model, n_iter=10)
    if dtype != torch.float32:  # the same weights, computing in `dtype`
        weights = model.state_dict()
        model = build_usot(mem_size=7, fused_xcorr=True, dtype=dtype)
        model.load_state_dict(weights)
    p = TrackerConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    frames = synthetic_video(2 * n + 1)
    engine = BatchScanEngine(model, p, canvas_h=480, canvas_w=640,
                             batch=batch, max_frames=256, chunk=n,
                             fused_head=fused_head, device=device)
    videos = [(frames[0], np.array([200.0, 240.0]), np.array([60.0, 60.0]))
              for _ in range(batch)]
    state = engine.init_batch(videos, ModelRunner(model, device=device))
    single = np.stack(frames[1:])
    lanes = np.broadcast_to(single[None], (batch,) + single.shape)
    return engine, state, engine.stage_frames(lanes, np.full(batch, 2 * n))


def profile(batch: int, n: int, fused_head: bool,
            dtype: torch.dtype = torch.float32) -> dict:
    engine, state, staged = staged_engine(batch, n, fused_head, dtype)
    with FlopCounterMode(display=False) as flops:   # the warm chunk
        state, _, _, _ = engine.track_staged(state, staged[:1])

    def run():
        engine.track_staged(state, staged[1:])  # ends in a copy to host
        torch.cuda.synchronize()

    prof = device_profile(run, n)
    return {"card": card_line(), "engine": "BatchScanEngine",
            "batch": batch, "instance": engine.p.instance_size,
            "fused_head": fused_head, "dtype": str(dtype),
            "ring_dtype": str(state.mem_enc[0].dtype),
            "frames_per_s": batch * 1e3 / prof["wall_ms_per_step"],
            "aten_gflop_per_step": {
                str(k): v / n / 1e9
                for k, v in flops.get_flop_counts()["Global"].items()},
            "profile": prof}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--fused-head", action="store_true",
                    help="run the heads on folded BN weights")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the engine's compute dtype")
    args = ap.parse_args(argv)
    f32_numerics()
    out = profile(args.batch, args.frames, args.fused_head,
                  getattr(torch, args.dtype))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
