"""Where a frame step's time goes in the port's batch engine, or a
training step's in the trainer, on one GPU.

    python -m usot_tpu_torch.tools.profile_engine [--batch 32]
                                                  [--frames 16]
                                                  [--fused-head]
                                                  [--dtype bfloat16]
    python -m usot_tpu_torch.tools.profile_engine --train [--batch 12]
                                                  [--frames 8]

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
and per step the wall and device-busy ms (busy: the union of the device
operations' intervals), the device idle share, the idle ms by the
innermost program span (`utils.profiling.span`) the host was in, each
span's self ms, the kernel launches (in all and by kernel), K1's device
ms and the kernels with the most device time.

`--train`: the cycle-memory step (`make_train_step(cycle_memory=True,
stage_bn_train=True)` over `build_optimizer(..., unfix=True)`, 4 memory
frames, `bench_train`'s hyper-parameters and synthetic batch) at the
full width, `--batch` samples, each loss read back after its step, as
the benchmark's training cell runs it. After 2 warm steps, `--frames`
steps untimed by any profiler, the step's spans (`train.step`,
`.forward`, `.backward`, `.gate`, `.update`) timed with `time.time_ns()`
at the same boundaries (`host_clock`): the host ms of each, and the
enqueue (the step less its gate's wait). Then `--frames` steps under
`torch.profiler`, reported as above. Needs a GPU.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
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
from usot_tpu_torch.utils import profiling

# K1 is the 3-scale instantiation of the tiled kernel (csrc/xcorr_tile.cuh)
K1_KERNEL = re.compile(r"xcorr_tile_kernel<[^>]*, 3>")
OUTSIDE = "outside any span"
WINDOW = "profile_engine.window"


def device_ops(events) -> list:
    """(start_ns, end_ns, name) of a trace's kernels, copies and fills:
    its CUDA events less the host's spans mirrored onto the device's
    timeline (GPU user annotations named `usot.<span>` or `WINDOW`)."""
    return [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith((profiling.PREFIX, WINDOW))]


def busy_intervals(ops, w0: int, w1: int) -> list:
    """The union of the ops' intervals clipped to the window [w0, w1]:
    sorted, disjoint [start, end] pairs, so overlapping work counts
    once."""
    union = []
    for start, end, _ in sorted(ops):
        start, end = max(start, w0), min(end, w1)
        if start >= end:
            continue
        if union and start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], end)
        else:
            union.append([start, end])
    return union


def innermost(record, starts, t: int) -> str:
    """The name of the innermost span of `record` (`profiling.spans()`,
    `starts` its start times in order) running at `t`. Spans nest, so
    it is the latest one started by `t` or one of its ancestors."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        if record[i].end_ns >= t:
            return record[i].name
        i = record[i].parent
    return OUTSIDE


def idle_by_span(union, w0: int, w1: int, record) -> dict:
    """Idle ns inside the window by the innermost program span the host
    was in at each gap's middle (`OUTSIDE` where none)."""
    starts = [s.start_ns for s in record]
    out, prev = defaultdict(int), w0
    for a, b in union + [[w1, w1]]:
        if a > prev:
            out[innermost(record, starts, (prev + a) // 2)] += a - prev
        prev = max(prev, b)
    return out


def clock_skew_us(events, record) -> list | None:
    """The median and the largest distance, us, between a recorded span's
    start or end and its `usot.` event's in the trace (both taken in
    start order): how far the record lies off the trace's clock."""
    cpu = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.device_type() == torch.autograd.DeviceType.CPU
                 and e.name().startswith(profiling.PREFIX))
    rec = sorted((s.start_ns, s.end_ns) for s in record)
    if not rec or len(cpu) != len(rec):
        return None
    far = sorted(max(abs(a - c), abs(b - d))
                 for (a, b), (c, d) in zip(rec, cpu))
    return [far[len(far) // 2] / 1e3, far[-1] / 1e3]


def device_profile(run, n_steps: int) -> dict:
    """`torch.profiler` over `run()` (which must end in a synchronize):
    per step the wall and device-busy ms (the union of the kernels',
    copies' and fills' intervals), the idle share, the device's idle ms
    by innermost program span, each span's self ms (host), the kernel
    launches, K1's device ms and the kernels with the most device time;
    and how far the span record lies off the trace's clock."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        # the session's first event pays the profiler's set-up: not a span
        with torch.profiler.record_function(WINDOW):
            w0 = time.time_ns()
            run()
            w1 = time.time_ns()
    events = prof.profiler.kineto_results.events()
    record = profiling.spans()
    ops = device_ops(events)
    by_name, count = defaultdict(float), defaultdict(int)
    for start, end, name in ops:
        by_name[name] += (end - start) / 1e6
        count[name] += 1
    union = busy_intervals(ops, w0, w1)
    wall = (w1 - w0) / 1e6
    busy = sum(b - a for a, b in union) / 1e6
    n = n_steps
    host = defaultdict(int)
    for s, own in zip(record, profiling.self_ns(record)):
        host[s.name] += own
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "steps": n, "wall_ms_per_step": wall / n,
        "device_busy_ms_per_step": busy / n if ops else None,
        "device_idle_share": 1 - busy / wall if ops else None,
        "idle_ms_per_step_by_span": {
            k: v / 1e6 / n for k, v in sorted(
                idle_by_span(union, w0, w1, record).items(),
                key=lambda kv: -kv[1])},
        "span_self_ms_per_step": {k: v / 1e6 / n for k, v in host.items()},
        "span_clock_skew_us": clock_skew_us(events, record),
        "kernels_per_step": len(ops) / n,
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


@contextlib.contextmanager
def host_clock(module):
    """While inside, `module`'s spans are timed with `time.time_ns()`
    alone, with no profiler: `module.span` is replaced by a context
    that appends each span's ns to the yielded dict's list under its
    name (the same boundaries the profiled spans mark)."""
    took = defaultdict(list)

    @contextlib.contextmanager
    def timed(name, id=None):
        start = time.time_ns()
        try:
            yield
        finally:
            took[name].append(time.time_ns() - start)

    saved, module.span = module.span, timed
    try:
        yield took
    finally:
        module.span = saved


def train_profile(batch: int, n: int) -> dict:
    """The `--train` record of the module note."""
    from usot_tpu_torch.tools.bench_train import (CLS_RATIO, LAMBDA_1,
                                                  LAYERS_LR, LR, MOMENTUM,
                                                  WEIGHT_DECAY, make_batch)
    from usot_tpu_torch.train import step as step_module
    from usot_tpu_torch.train.optim import build_optimizer

    device = resolve_device(None)
    model = build_usot(mem_size=4)
    init_model(model, torch.Generator().manual_seed(0), device=device)
    opt, _ = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR,
                             unfix=True)
    step = step_module.make_train_step(model, opt, cycle_memory=True,
                                       stage_bn_train=True,
                                       lambda_1=LAMBDA_1)
    data = {k: torch.from_numpy(v).to(device) for k, v in make_batch(
        np.random.default_rng(0), batch, True, 4).items()}

    def steps():
        for _ in range(n):   # each loss read back, as the cell does
            float(step(data, LR, CLS_RATIO)["loss"])
        torch.cuda.synchronize()

    for _ in range(2):
        float(step(data, LR, CLS_RATIO)["loss"])
    torch.cuda.synchronize()
    with host_clock(step_module) as took:
        t0 = time.time_ns()
        steps()
        wall = (time.time_ns() - t0) / 1e6 / n
    host = {k: sum(v) / len(v) / 1e6 for k, v in took.items()}
    enqueue = host["train.step"] - host.get("train.gate", 0.0)
    return {"card": card_line(), "train": "cycle_memory", "batch": batch,
            "untraced": {"wall_ms_per_step": wall,
                         "span_host_ms": host, "enqueue_ms": enqueue,
                         "samples_per_s": batch * 1e3 / wall},
            "skipped": step.skipped, "profile": device_profile(steps, n)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile the cycle-memory training step")
    ap.add_argument("--batch", type=int, default=None,
                    help="lanes (default 32), or samples with --train "
                    "(default 12)")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a chunk (default 16), or steps with "
                    "--train (default 8)")
    ap.add_argument("--fused-head", action="store_true",
                    help="run the heads on folded BN weights")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the engine's compute dtype")
    args = ap.parse_args(argv)
    f32_numerics()
    if args.train:
        out = train_profile(args.batch or 12, args.frames or 8)
    else:
        out = profile(args.batch or 32, args.frames or 16, args.fused_head,
                      getattr(torch, args.dtype))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
