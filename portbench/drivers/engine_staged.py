"""Driver: the batch engine (`BatchScanEngine`) on frames staged on the
card, round after round: `init_batch` on every lane's first frame, then
`track_staged` over the rest of the lane's video, a closed loop (a
lane's frame t + 1 is tracked only after frame t's box exists).

Traffic keys: `lanes`, `canvas` [h, w], `frames_per_video` (the init
frame and the tracked ones, a whole number of chunks), `chunk`,
`max_frames` (the engine's memory ring), `box_px` and `speed_px` (the
targets' sizes and speeds, `videos.py`), `trace_seconds` (the traced
window's length at most), `check_lanes` (lanes drawn from the seed that
the reference follows, each as one completed round of the window, also
drawn, tracked it).

Set-up warms the window's shapes with `init_batch` and one staged
chunk: every chunk of a round runs the same shapes.

End to end: `track_fps`, the frames all lanes tracked in the window
over its seconds (inits count as time, not as frames).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.checks import spread, track_checks
from portbench.drivers import program
from portbench.harness import Outcome
from portbench.reference.net import Net
from portbench.reference.tracker import Tracker
from portbench.trace import Profile, peak_bytes, release, span, sync
from portbench.videos import make_videos
from portbench.weights import tracking_weights


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    lanes, (h, w), chunk = tr["lanes"], tr["canvas"], tr["chunk"]
    n = tr["frames_per_video"]
    if (n - 1) % chunk:
        raise ValueError("frames_per_video - 1 must be whole chunks")
    video, pos0, sz0 = make_videos(ctx.seed, lanes, n, h, w, tr["box_px"],
                                   tr["speed_px"], dev)
    first = [video[0, i].cpu().numpy() for i in range(lanes)]
    weights = tracking_weights(ctx.seed, cfg, first, pos0, sz0, dev)

    from usot_tpu_torch.tracker.engine import BatchScanEngine
    from usot_tpu_torch.tracker.runner import ModelRunner

    model = program.model(cfg, weights, dev)
    runner = ModelRunner(model, device=dev)
    engine = BatchScanEngine(model, program.tracker_config(cfg), canvas_h=h,
                             canvas_w=w, batch=lanes,
                             max_frames=tr["max_frames"], chunk=chunk,
                             device=dev)
    valid = torch.ones((chunk, lanes), dtype=torch.bool, device=dev)
    staged = [(chunk, video[i:i + chunk], valid)
              for i in range(1, n, chunk)]
    inits = [(first[i], pos0[i], sz0[i]) for i in range(lanes)]

    def one_round(chunks=staged):
        with span("init"):
            state = engine.init_batch(inits, runner)
        with span("track_staged"):
            return engine.track_staged(state, chunks)[1:]

    with span("warm"):
        one_round(staged[:1])
    sync(dev)
    limit = ctx.window_limit()
    k1 = program.k1_launches()
    rounds, ends = [], []
    with Profile(ctx.trace) as prof:
        t_first = time.time()
        t0 = time.perf_counter()
        while not rounds or time.perf_counter() - t0 < limit:
            rounds.append(one_round())
            ends.append(time.perf_counter() - t0)
        window = time.perf_counter() - t0
    k1 = program.k1_launches() - k1
    peak = peak_bytes(dev)
    summary = prof.summary()
    steps = len(rounds) * (n - 1)
    frames = steps * lanes
    bad = sum(int(np.sum(~np.isfinite(r[0]).all(-1))) for r in rounds)

    rng = np.random.default_rng([ctx.seed, 1])
    sample = np.sort(rng.choice(lanes, tr["check_lanes"], replace=False))
    pick = rng.integers(len(rounds), size=len(sample))
    judged = video[:, torch.as_tensor(sample, device=dev)].transpose(0, 1) \
        .contiguous()
    del engine, runner, model, staged, video
    release(dev)
    forced = tuple(np.stack([rounds[r][k][i] for i, r in zip(sample, pick)])
                   for k in range(3))
    with torch.no_grad():
        tracker = Tracker(Net(weights), cfg["tracker"])
        _, readings = tracker.track(judged, [(pos0[i], sz0[i])
                                             for i in sample], forced=forced)
    return Outcome(
        e2e={"track_fps": frames / window, "setup_s": t_first - ctx.started},
        attempted=frames, failed=bad,
        checks=track_checks(readings, cfg["limits"]["engine_staged"]),
        memory_peak_bytes=peak, trace=summary,
        counts={"steps": steps, "frames": frames, "lanes": lanes,
                "k1_launches": k1},
        notes=[f"window {window:.3f} s: {len(rounds)} rounds, {frames} "
               f"frames; K1 launches per frame step {k1 / steps:.3f}; "
               f"checked lanes {sample.tolist()} of rounds "
               f"{pick.tolist()}; rounds ended at "
               f"{[round(e, 3) for e in ends]} s",
               spread(readings)])
