"""Driver: OSTrack's batch engine (`OSTrackBatchEngine`) on frames staged
on the card, round after round: `init_batch` on every lane's first frame
(the template cropped and embedded once), then `track_staged` over the
rest of the lane's video, a closed loop (a lane's frame t + 1 is
tracked only after frame t's box exists).

Traffic keys as `engine_staged`'s but `max_frames` (no memory ring):
`lanes`, `canvas` [h, w], `frames_per_video` (the init frame and the
tracked ones, a whole number of chunks), `chunk`, `box_px` and
`speed_px` (`videos.py`), `trace_seconds`, `check_lanes`. The
configuration's `sizes` are the model's and the tracker's, `weights` the
seeded recipe's (`weights_ostrack.py`).

Set-up warms the window's shapes with `init_batch` and one staged chunk.
End to end: `track_fps`, the frames all lanes tracked in the window over
its seconds (inits count as time, not as frames).

The check: the plain reference (`reference/ostrack.py`, float32) follows
`check_lanes` lanes, each over one completed round of the window (both
drawn from the seed), from the program's outputs: at each frame's crop
and CE stage it ranks the tokens itself and counts those of its top set
the program dropped (`swaps`, summed over the stages), then keeps the
program's set, and reads `gap`, `box_px` and `score` at the program's
pick (`checks.track_checks`). `ce_tokens_off` holds the program's CE
counter over the window (`ce_kept_counts()`) against the published kept
counts times lanes times steps: the counter adds the kept sets' sizes,
so it catches a change of a keep ratio or a CE location, and never which
tokens were kept (`swaps` reads that).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.checks import spread, track_checks
from portbench.harness import Outcome
from portbench.reference import ostrack as ref
from portbench.trace import Profile, peak_bytes, release, span, sync
from portbench.videos import make_videos
from portbench.weights_ostrack import tracking_weights


def model(config: dict, weights: dict, device):
    """The program's OSTrack at the configuration's sizes and compute
    dtype on `device`, holding `weights`."""
    from usot_tpu_torch.models import ostrack

    s = config["sizes"]
    m = ostrack.build_ostrack(
        dtype=getattr(torch, config["dtype"]), dim=s["dim"],
        depth=s["depth"], heads=s["heads"], hidden=s["mlp"],
        patch=s["patch"], template=s["template"], search=s["search"],
        head_channels=s["head_channels"], ce_loc=tuple(s["ce_loc"]),
        keep=s["keep"])
    m.to(device)
    ostrack.load_ostrack_state(m, weights)
    return m


def run(ctx) -> Outcome:
    # the program's modules first: a program without them fails here, at once
    from usot_tpu_torch.models.vit_ce import ce_kept_counts
    from usot_tpu_torch.tracker.ostrack_engine import OSTrackBatchEngine

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    s = cfg["sizes"]
    lanes, (h, w), chunk = tr["lanes"], tr["canvas"], tr["chunk"]
    n = tr["frames_per_video"]
    if (n - 1) % chunk:
        raise ValueError("frames_per_video - 1 must be whole chunks")
    video, pos0, sz0 = make_videos(ctx.seed, lanes, n, h, w, tr["box_px"],
                                   tr["speed_px"], dev)
    first = [video[0, i].cpu().numpy() for i in range(lanes)]
    boxes = np.concatenate([pos0 - sz0 / 2, sz0], axis=1)
    weights = tracking_weights(ctx.seed, cfg, first, boxes, dev)

    engine = OSTrackBatchEngine(model(cfg, weights, dev), lanes, chunk=chunk,
                                device=dev)
    valid = torch.ones((chunk, lanes), dtype=torch.bool, device=dev)
    staged = [(chunk, video[i:i + chunk], valid)
              for i in range(1, n, chunk)]
    inits = [(first[i], pos0[i], sz0[i]) for i in range(lanes)]

    def one_round(chunks=staged):
        with span("init"):
            state = engine.init_batch(inits)
        with span("track_staged"):
            return engine.track_staged(state, chunks)[1:]

    with span("warm"):
        one_round(staged[:1])
    sync(dev)
    limit = ctx.window_limit()
    kept0 = ce_kept_counts()
    rounds, ends = [], []
    with Profile(ctx.trace) as prof:
        t_first = time.time()
        t0 = time.perf_counter()
        while not rounds or time.perf_counter() - t0 < limit:
            rounds.append(one_round())
            ends.append(time.perf_counter() - t0)
        window = time.perf_counter() - t0
    kept = [a - b for a, b in zip(ce_kept_counts(),
                                  kept0 + [0] * len(s["ce_loc"]))]
    peak = peak_bytes(dev)
    summary = prof.summary()
    steps = len(rounds) * (n - 1)
    frames = steps * lanes
    bad = sum(int(np.sum(~np.isfinite(r[0]).all(-1))) for r in rounds)
    want = [k * lanes * steps for k in ref.kept_counts(s)]
    off = float(sum(abs(a - b) for a, b in zip(kept, want))
                + abs(len(kept) - len(want)) * max(want))

    rng = np.random.default_rng([ctx.seed, 1])
    sample = np.sort(rng.choice(lanes, tr["check_lanes"], replace=False))
    pick = rng.integers(len(rounds), size=len(sample))
    judged = [video[:, int(i)].cpu().numpy() for i in sample]
    del engine, staged, video
    release(dev)
    forced = tuple(np.stack([rounds[r][k][i] for i, r in zip(sample, pick)])
                   for k in range(4))
    limits = dict(cfg["limits"]["engine_staged_ostrack"])
    ce_limit = limits.pop("ce_tokens_off")
    with torch.no_grad():
        _, readings = ref.Tracker(weights, s).track(judged, boxes[sample],
                                                    forced=forced)
    checks = track_checks(readings, limits)
    checks["ce_tokens_off"] = (off, float(ce_limit))
    return Outcome(
        e2e={"track_fps": frames / window, "setup_s": t_first - ctx.started},
        attempted=frames, failed=bad, checks=checks,
        memory_peak_bytes=peak, trace=summary,
        counts={"steps": steps, "frames": frames, "lanes": lanes},
        notes=[f"window {window:.3f} s: {len(rounds)} rounds, {frames} "
               f"frames; CE kept {kept} (published {want}); checked lanes "
               f"{sample.tolist()} of rounds {pick.tolist()}; rounds ended "
               f"at {[round(e, 3) for e in ends]} s", spread(readings)])
