"""Driver: pseudo-label mining as the port's `cli/parse_flow.main` runs
it, video after video: `inference_sequence` (PWCLite in 3-frame mode on
the card, the adaptive interval loop, `flow_to_bbox` and the DP on the
host), `video_record`, `crop_video_frames` (crop511 of every frame) and,
after each pass over the videos, `build_train_json`. A closed loop: one
miner, one video at a time, as `main` mines a dataset.

The videos (`mine_inputs.py`) are decoded frames held in host memory,
read through an in-memory reader; the crops go to an in-memory writer
that keeps the judged video's alone. The flow network is the
configuration's (`FlowHelper` from the weights of its `weights_seed`
and `flow_gain`, built once); the mining settings are the
configuration's `mining`. The run's seed deals the videos' order, seeds
the DP's perturbations and draws the judged video.

Traffic keys: `frame` [h, w], `lengths` (one video each), `objects`,
`object_frac`, `speed_px`, `pan_px`, `content_seed`
(`mine_inputs.make_videos`), `warm_frames` (the warm-up video's
length), `trace_seconds`.

Set-up renders the videos, makes the weights, builds the helper and
mines one short video (every shape of the window: the frame's, the
test shape's, the crop's). The window mines whole videos, in the seed's
order and round again, until `--seconds` have passed, the last video
included.

The check: one video of the window, drawn from the seed (reservoir
sampling, so only its crops are kept), judged by the plain reference
from the program's outputs (`checks.mine_numbers`).

End to end: `mine_fps`, every frame of the videos mined in the window
over its seconds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.checks import mine_numbers
from portbench.harness import Outcome
from portbench.mine_inputs import flow_weights, make_videos, render, with_gain
from portbench.reference import mining as ref_mining
from portbench.trace import Profile, peak_bytes, release, span, sync


WARM = 0xFFFFFFFF  # the warm-up video's ordinal


def dp_seed(seed: int, ordinal: int) -> list:
    """The DP's `RandomState` seed of the window's `ordinal`-th video."""
    return [seed & 0xFFFFFFFF, seed >> 32, ordinal]


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    mine_cfg = cfg["mining"]
    h, w = tr["frame"]
    videos = [f[:mine_cfg["max_frames"]]
              for _, f in make_videos(ctx.seed, tr, dev)]
    warm_plan = dict(length=tr["warm_frames"], pan=1.0, objects=[dict(
        size=(w // 5, h // 5), speed=(2.0, 1.0), phase=np.array([0.2, 0.3]))])
    warm = render(warm_plan, tr["content_seed"], len(videos), h, w, dev)
    weights = with_gain(flow_weights(cfg["weights_seed"], dev),
                        cfg["flow_gain"])
    if dev.type == "cuda":  # the peak is the program's, not the render's
        torch.cuda.reset_peak_memory_stats(dev)

    from usot_tpu_torch.cli.parse_flow import video_record
    from usot_tpu_torch.preprocessing.crop_gen import (build_train_json,
                                                       crop_video_frames)
    from usot_tpu_torch.preprocessing.inference import (FlowHelper,
                                                        inference_sequence)

    helper = FlowHelper(weights, test_shape=cfg["test_shape"], device=dev)
    crop_root = ctx.root / ".portbench_cache" / "crop511"

    def mine(name, frames, ordinal, writer):
        """`main`'s body for one video: (decisions, result or the error)."""
        reader, ids = frames.__getitem__, list(range(len(frames)))
        decisions = []
        try:
            with span("infer"):
                out = inference_sequence(
                    helper, ids, gap=mine_cfg["gap"],
                    init_adjacent=mine_cfg["init_adjacent"],
                    rng=np.random.RandomState(dp_seed(ctx.seed, ordinal)),
                    decisions=decisions, reader=reader)
        except ValueError as e:  # no candidate box: `main` drops the video
            return decisions, e, None
        record = video_record(out[0], out[2], reader(ids[0]).shape)
        with span("crop"):
            crop_video_frames(ids, out[0], 0, str(crop_root / name),
                              instance_size=mine_cfg["instance_size"],
                              reader=reader, writer=writer)
        return decisions, out, record

    def to_json(raw):
        with span("json"):
            build_train_json(raw, quality_gate=mine_cfg["quality_gate"])

    with span("warm"):
        _, _, record = mine("warm", warm, WARM, lambda path, image: None)
        to_json({"warm": record} if record else {})
    sync(dev)

    limit = ctx.window_limit()
    pick = np.random.default_rng([ctx.seed, 5])
    mined, frames_done, raw, judged, ends = [], 0, {}, None, []
    with Profile(ctx.trace) as prof:
        t_first = time.time()
        t0 = time.perf_counter()
        while not mined or time.perf_counter() - t0 < limit:
            k = len(mined)
            frames = videos[k % len(videos)]
            name, crops = f"video{k:04d}", {}
            decisions, out, record = mine(name, frames, k, crops.__setitem__)
            mined.append((len(frames), decisions, out))
            if record is not None:
                raw[name] = record
                frames_done += len(frames)
            if pick.integers(len(mined)) == 0:
                judged = (k, crops)
            if (k + 1) % len(videos) == 0:
                to_json(raw)
                raw = {}
            ends.append(time.perf_counter() - t0)
        if raw:
            to_json(raw)
        window = time.perf_counter() - t0
    peak = peak_bytes(dev)
    summary = prof.summary()
    del helper
    release(dev)

    k, crops = judged
    frames = videos[k % len(videos)]
    _, decisions, out = mined[k]
    prog = {"decisions": decisions, "crops": crops,
            "mined": None if isinstance(out, ValueError) else out}
    ref = ref_mining.replay(weights, frames, decisions, cfg, dp_seed(ctx.seed,
                                                                     k), dev)
    numbers, readings = mine_numbers(prog, ref, frames, cfg, dev)
    limits = cfg["limits"]["mine_videos"]
    forwards = sum(len(d) for _, d, _ in mined)
    moved = sum(sum(c > 1 for c in np.unique([f for f, _, _ in d],
                                             return_counts=True)[1])
                for _, d, _ in mined if d)
    kept = sum(len(range(mine_cfg["gap"], n - mine_cfg["gap"],
                         mine_cfg["gap"])) for n, _, _ in mined)
    failed = sum(isinstance(o, ValueError) for _, _, o in mined)
    found = [o[2][1] for _, _, o in mined if not isinstance(o, ValueError)]
    picked = [o[2][2] for _, _, o in mined if not isinstance(o, ValueError)]
    return Outcome(
        e2e={"mine_fps": frames_done / window,
             "setup_s": t_first - ctx.started},
        attempted=len(mined), failed=failed,
        checks={n: (v, float(limits[n])) for n, v in numbers.items()},
        memory_peak_bytes=peak, trace=summary,
        counts={"forwards": forwards, "kept_flows": kept,
                "frames": frames_done, "videos": len(mined)},
        notes=[f"window {window:.3f} s: {len(mined)} videos "
               f"({failed} dropped), {frames_done} frames mined, "
               f"{forwards} forwards for {kept} kept flows "
               f"({forwards / max(kept, 1):.4f} a flow; {moved} kept "
               f"after more than one forward); candidate share "
               f"{np.round(found, 4).tolist()}; picked share "
               f"{np.round(picked, 4).tolist()}; videos ended at "
               f"{[round(e, 3) for e in ends]} s",
               f"judged video {k} ({len(frames)} frames): {readings}"])
