"""Driver: one client of the B=1 tracker (`USOTTracker` through
`ModelRunner`, the path of the TraX entry point), closed loop: per video
`init` on its first frame, then one `track` per frame, each handed the
frame as uint8 in host memory and waited for until its box is on the
host. The videos play in turn, from the first again after the last.

Traffic keys: `frame` [h, w], `lengths` (the videos' frame counts: one
set for every seed, played in an order drawn from the seed), `box_px`,
`speed_px`, `trace_seconds`, `check_frames` (at least this many
tracked frames the reference follows: whole videos of the window drawn
from the seed, the longest among them).

End to end: `frame_ms_p95`, the 95th percentile over every request of
the window (an init is one) of its milliseconds; the median and the
count are noted on standard error.
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
from portbench.videos import lane_plans, render
from portbench.weights import tracking_weights


def host_videos(seed: int, tr: dict, device) -> list:
    """[(frames (n, h, w, 3) uint8 numpy, pos0, sz0)] in play order: one
    video per length of `lengths`, their targets one fixed set of sizes
    dealt by the seed (`videos.lane_plans`)."""
    h, w = tr["frame"]
    rng = np.random.default_rng([seed, 3])
    plans = lane_plans(rng, len(tr["lengths"]), h, w, tr["box_px"],
                       tr["speed_px"])
    out = []
    for i in rng.permutation(len(tr["lengths"])):
        video, pos, sz = render([plans[i]], seed + 1000 * (int(i) + 1),
                                tr["lengths"][i], h, w, device)
        out.append((video[:, 0].cpu().numpy(), pos[0], sz[0]))
        del video
    return out


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    videos = host_videos(ctx.seed, tr, dev)
    weights = tracking_weights(ctx.seed, cfg, [v[0][0] for v in videos],
                               [v[1] for v in videos],
                               [v[2] for v in videos], dev)

    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.tracker.tracker import USOTTracker

    runner = ModelRunner(program.model(cfg, weights, dev), device=dev)
    tracker = USOTTracker(hp=dict(cfg["tracker"]))

    def play(video, frames_left, record):
        """Tracks `video` until it ends or `frames_left()` says stop;
        appends each request's seconds and each frame's output."""
        frames, pos, sz = video
        t = time.perf_counter()
        with span("init"):
            state = tracker.init(frames[0], pos, sz, runner)
        record["ms"].append((time.perf_counter() - t) * 1e3)
        if state["p"].instance_size != cfg["tracker"]["instance_size"]:
            raise ValueError("a target under the small-target share: the "
                             "traffic's boxes must keep the search size")
        out = []
        for f in range(1, len(frames)):
            if not frames_left():
                break
            t = time.perf_counter()
            with span("track"):
                state = tracker.track(state, frames[f])
            record["ms"].append((time.perf_counter() - t) * 1e3)
            out.append((state["target_pos"].copy(),
                        state["target_sz"].copy(), state["cls_score"]))
        return out

    with span("warm"):
        play(videos[0], lambda: True, {"ms": []})
    sync(dev)
    limit = ctx.window_limit()
    record, played = {"ms": []}, []
    with Profile(ctx.trace) as prof:
        t_first = time.time()
        t0 = time.perf_counter()

        def going():
            return time.perf_counter() - t0 < limit
        while not played or going():
            k = len(played) % len(videos)
            played.append((k, play(videos[k], going, record)))
        sync(dev)
        window = time.perf_counter() - t0
    peak = peak_bytes(dev)
    summary = prof.summary()
    tracked = sum(len(out) for _, out in played)
    bad = sum(not np.all(np.isfinite(p)) for _, out in played
              for p, _, _ in out)
    del runner
    release(dev)

    readings = judge(ctx, weights, videos, played)
    ms = np.asarray(record["ms"])
    return Outcome(
        e2e={"frame_ms_p95": float(np.percentile(ms, 95)),
             "setup_s": t_first - ctx.started},
        attempted=len(ms), failed=bad,
        checks=track_checks(readings, cfg["limits"]["tracker_live"]),
        memory_peak_bytes=peak, trace=summary,
        counts={"frames": tracked, "requests": len(ms),
                "videos": len(played)},
        notes=[f"window {window:.3f} s: {len(ms)} requests ({len(played)} "
               f"inits), median {float(np.median(ms)):.4f} ms, p95 "
               f"{float(np.percentile(ms, 95)):.4f} ms", spread(readings)])


def judge(ctx, weights, videos, played) -> dict:
    """The reference follows whole played videos drawn from the seed, the
    longest first, until `check_frames` tracked frames are covered."""
    rng = np.random.default_rng([ctx.seed, 4])
    runs = [i for i in rng.permutation(len(played)) if played[i][1]]
    runs.sort(key=lambda i: -len(played[i][1]))
    chosen, total = [], 0
    for i in [runs[0]] + list(rng.permutation(runs[1:])):
        if total >= ctx.traffic["check_frames"]:
            break
        chosen.append(i)
        total += len(played[i][1])
    tracker = Tracker(Net(weights), ctx.config["tracker"])
    readings = {}
    with torch.no_grad():
        for i in chosen:
            k, out = played[i]
            frames, pos, sz = videos[k]
            forced = tuple(np.stack([o[j] for o in out])[None]
                           for j in range(3))
            _, r = tracker.track([frames[:len(out) + 1]], [(pos, sz)],
                                 forced=forced, crop="host")
            for name, v in r.items():
                readings.setdefault(name, []).append(v.ravel())
    return {k: np.concatenate(v) for k, v in readings.items()}
