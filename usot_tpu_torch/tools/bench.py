"""Headline benchmark of the port: single-card USOT* tracking throughput
with the batched engine. The counterpart of the repo's `bench.py`.

    python -m usot_tpu_torch.tools.bench [--device cpu] [--json <path>]

BENCH_BATCH videos are tracked in lockstep by `BatchScanEngine`; each
frame step crops, runs the backbone, the offline and online heads (K1,
`xcorr_groupdw_cuda`, three launches per step on the card), the
postprocess and the memory write. Legs, in `bench.py`'s order, each in a
`compile_watch` phase: `init_batch`; a warm chunk; the rest of the video
streamed as full frames; `suggest_roi`, then the ROI programs and the
full-frame replay warmed at the stream chunk and `track_batch_roi` (or
its logged skip when the window does not fit the canvas); the rest
staged on the card (`stage_frames`) and tracked BENCH_REPEATS times
(`track_staged`), reporting the MEDIAN. Every timed region ends on a
synchronize.

Knobs (environment, `bench.py`'s names and defaults): BENCH_FRAMES 129,
BENCH_CHUNK 64, BENCH_BATCH 32, BENCH_MODE staged|stream, BENCH_DTYPE
bf16 (else f32: float32 with TF32 off), BENCH_H/BENCH_W 480x640,
BENCH_ROI auto (0 skips the leg, an integer forces the window),
BENCH_STREAM_CHUNK 16, BENCH_REPEATS 5, BENCH_CKPT. BENCH_S2B=1 names
`s2b_dilated`, a TPU layout rewrite the port leaves out: it raises.

Weights: BENCH_CKPT; else `regen_bench_ckpt`'s
`var/full_schedule_torch/unbroken/snapshot/checkpoint_e30.pth` where it
exists; else seeded random weights (`init_model`, seed 0) with BN stats
calibrated by 8 passes, cached in `var/bench_weights.pth`. The file used
and its sha256 are logged.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}, the
value aggregate tracked frames/s on one card, the baseline the paper's
real-time claim (~58 FPS on one GPU, arXiv 2108.12711). `--json` writes
the full record: each leg's frames/s, the staged repeats and their
median, the ROI telemetry, the compile lines, K1's launches in the
staged leg, the weights and the card's name and power limit. Runs on
the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_FPS = 58.0
METRIC = "usot_star_tracking_throughput_fps_per_chip"
TRAINED_CKPT = "var/full_schedule_torch/unbroken/snapshot/checkpoint_e30.pth"
RANDOM_CACHE = "var/bench_weights.pth"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def knobs(env=None) -> dict:
    """`bench.py`'s environment knobs, with its defaults."""
    env = os.environ if env is None else env
    if env.get("BENCH_S2B") == "1":
        raise ValueError("BENCH_S2B=1 asks for s2b_dilated, a TPU layout "
                         "rewrite of layer3 that the port leaves out")
    return dict(frames=int(env.get("BENCH_FRAMES", "129")),
                chunk=int(env.get("BENCH_CHUNK", "64")),
                batch=int(env.get("BENCH_BATCH", "32")),
                mode=env.get("BENCH_MODE", "staged"),
                dtype=env.get("BENCH_DTYPE", "bf16"),
                h=int(env.get("BENCH_H", "480")),
                w=int(env.get("BENCH_W", "640")),
                roi=env.get("BENCH_ROI", "auto"),
                stream_chunk=int(env.get("BENCH_STREAM_CHUNK", "16")),
                repeats=int(env.get("BENCH_REPEATS", "5")),
                ckpt=env.get("BENCH_CKPT") or None)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_weights(ckpt, device):
    """(state dict, its file, the file's sha256), in `bench.py`'s order:
    `ckpt`; else the trained checkpoint where it exists; else the cached
    calibrated random weights, made and cached first if need be."""
    from usot_tpu_torch.train.checkpoint import load_model_state

    if not ckpt and os.path.exists(TRAINED_CKPT):
        ckpt = TRAINED_CKPT
        log(f"bench: using trained checkpoint {ckpt}")
    if ckpt:
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"BENCH_CKPT {ckpt}")
        path = ckpt
        weights = load_model_state(ckpt)
    else:
        path = RANDOM_CACHE
        if os.path.exists(path):
            log("bench: loaded cached calibrated weights")
        else:
            from usot_tpu_torch.models.calibrate import calibrate_batch_stats
            from usot_tpu_torch.models.usot import build_usot, init_model

            model = build_usot(mem_size=4)
            init_model(model, torch.Generator().manual_seed(0), device=device)
            calibrate_batch_stats(model, n_iter=8)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save({k: t.cpu() for k, t in model.state_dict().items()},
                       path)
        weights = torch.load(path, map_location="cpu", weights_only=True)
    digest = sha256(path)
    log(f"bench: weights {path} sha256 {digest}")
    return weights, path, digest


def _config():
    from usot_tpu_torch.tracker.config import TrackerConfig

    p = TrackerConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def run(weights, device, frames=129, chunk=64, batch=32, mode="staged",
        dtype="bf16", h=480, w=640, roi="auto", stream_chunk=16, repeats=5,
        width=64, channels=256, log=log):
    """`bench.py`'s legs on `device` with the model of `width`/`channels`
    (`build_usot(mem_size=4, fused_xcorr=True)`) holding `weights`,
    computing in `dtype` ("bf16" or "f32"). Returns the record: per leg
    its seconds and frames/s, the ROI decision and telemetry, the staged
    repeats and their median, the compile lines, K1's launches in the
    staged leg, the JSON line (`"line"`) and, under `"tracks"`, each
    leg's (pos, sz, score) numpy outputs."""
    from usot_tpu_torch.core.device import f32_numerics
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.ops.xcorr_kernel import launch_counts
    from usot_tpu_torch.tracker.engine import BatchScanEngine, synthetic_video
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.utils.compile_watch import get_watch

    device = torch.device(device)
    f32_numerics()
    watch = get_watch()
    compile_lines: list = []

    def phase(name):
        return watch.phase(name, log, compile_lines)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if dtype not in ("bf16", "f32"):
        raise ValueError(f"BENCH_DTYPE {dtype!r}: bf16 or f32")
    video = synthetic_video(frames, h=h, w=w)
    log("bench: building model")
    model = build_usot(mem_size=4, width=width, channels=channels,
                       fused_xcorr=True, dtype=torch.bfloat16
                       if dtype == "bf16" else torch.float32)
    model.load_state_dict(weights)
    runner = ModelRunner(model, device=device)
    log("bench: weights ready")
    engine = BatchScanEngine(model, _config(), canvas_h=h, canvas_w=w,
                             batch=batch, max_frames=max(256, frames + 8),
                             chunk=chunk, device=device)
    videos = [(video[0], np.array([200.0, 240.0]), np.array([60.0, 60.0]))
              for _ in range(batch)]
    rec = {"knobs": dict(frames=frames, chunk=chunk, batch=batch, mode=mode,
                         dtype=dtype, h=h, w=w, roi=roi,
                         stream_chunk=stream_chunk, repeats=repeats,
                         width=width, channels=channels),
           "device": str(device), "legs": {}, "tracks": {}}
    legs, tracks = rec["legs"], rec["tracks"]

    t0 = time.perf_counter()
    with phase("init_batch"):
        state = engine.init_batch(videos, runner)
        sync()
    legs["init_batch"] = {"s": time.perf_counter() - t0}
    log(f"bench: video init done in {legs['init_batch']['s']:.1f}s")

    single = np.stack(video[1:])
    # every lane tracks the same video (identical per-lane work; the
    # engine stores and processes every lane independently)
    all_frames = np.broadcast_to(single[None], (batch,) + single.shape)
    rest = all_frames[:, chunk:]
    n_rest = rest.shape[1]

    t0 = time.perf_counter()
    with phase("scan_chunk"):
        state, *out = engine.track_batch(state, all_frames[:, :chunk],
                                         n_valid=np.full(batch, chunk))
        sync()
    dt = time.perf_counter() - t0
    legs["warm_chunk"] = {"s": dt, "fps": batch * chunk / dt}
    tracks["warm_chunk"] = out
    log(f"bench: first chunk in {dt:.1f}s")

    t0 = time.perf_counter()
    with phase("fullframe_stream"):
        state, *out = engine.track_batch(state, rest,
                                         n_valid=np.full(batch, n_rest))
        sync()
    dt = time.perf_counter() - t0
    full_stream_fps = batch * n_rest / dt
    legs["fullframe_stream"] = {"s": dt, "fps": full_stream_fps}
    tracks["fullframe_stream"] = out
    log(f"bench: full-frame streaming: {full_stream_fps:.1f} fps")

    roi_px = engine.suggest_roi(state, chunk=stream_chunk) \
        if roi == "auto" else int(roi)
    sz_now = state.sz.cpu().numpy()
    log(f"bench: suggest_roi -> {roi_px} (canvas {w}x{h}, init span "
        f"{engine._init_span:.0f}, live sz max {sz_now.max():.0f})")
    roi_rec = {"roi": roi_px, "suggested": roi == "auto"}
    if roi_px and roi_px < min(h, w):
        t0 = time.perf_counter()
        with phase("roi_chunk"):
            engine.warm_roi(state, roi_px, chunk=stream_chunk)
            # the full-frame replay path at the stream chunk must not be
            # used first inside the timed region
            state, outs = engine.run_chunk(
                state, torch.zeros((stream_chunk, batch, h, w, 3),
                                   dtype=torch.uint8, device=device),
                torch.zeros((stream_chunk, batch), dtype=torch.bool,
                            device=device))
            outs[0].cpu()
        roi_rec["warm_s"] = time.perf_counter() - t0
        log(f"bench: ROI chunk paths ready in {roi_rec['warm_s']:.1f}s")
        t0 = time.perf_counter()
        state, *out = engine.track_batch_roi(
            state, rest, n_valid=np.full(batch, n_rest), roi=roi_px,
            chunk=stream_chunk)
        sync()
        dt = time.perf_counter() - t0
        stream_fps = batch * n_rest / dt
        tracks["roi"] = out
        roi_rec.update(s=dt, fps=stream_fps,
                       vs_full_frame=stream_fps / full_stream_fps,
                       **{k: getattr(engine, k) for k in (
                           "roi_accepted", "roi_replays", "roi_chunks",
                           "roi_escalations", "roi_final", "roi_fallback",
                           "roi_bytes_sent", "roi_bytes_full_equiv")})
        log(f"bench: ROI-{roi_px}/chunk-{stream_chunk} streaming: "
            f"{stream_fps:.1f} fps = {stream_fps / full_stream_fps:.2f}x "
            f"full-frame ({engine.roi_replays}/{engine.roi_chunks} chunks "
            f"replayed, {engine.roi_escalations} escalations -> roi "
            f"{engine.roi_final}"
            f"{', FELL BACK to full frames' if engine.roi_fallback else ''}"
            f"; sent {engine.roi_bytes_sent / 1e6:.0f}MB vs "
            f"{engine.roi_bytes_full_equiv / 1e6:.0f}MB full-frame)")
    else:
        log("bench: ROI leg skipped — suggested window does not fit "
            "inside the canvas (streaming full frames is the correct "
            "policy there; see the engine's cost-based fallback)")
        roi_rec["skipped"] = True
        stream_fps = full_stream_fps
    legs["roi"] = roi_rec

    t0 = time.perf_counter()
    staged = engine.stage_frames(rest, n_valid=np.full(batch, n_rest))
    sync()
    stage_s = time.perf_counter() - t0
    log(f"bench: staged {batch * n_rest} frames ({rest.nbytes / 1e6:.0f}MB)"
        f" in {stage_s:.1f}s")
    k1_before = launch_counts()["K1"]
    staged_fps, staged_tracks = [], []
    for r in range(repeats):
        t0 = time.perf_counter()
        if r == 0:
            with phase("staged_program"):
                state, *out = engine.track_staged(state, staged)
                sync()
        else:
            state, *out = engine.track_staged(state, staged)
            sync()
        dt = time.perf_counter() - t0
        staged_fps.append(batch * n_rest / dt)
        staged_tracks.append(out)
        log(f"bench: staged repeat {r}: {staged_fps[-1]:.1f} fps")
    steps = repeats * len(staged) * engine.chunk
    med = float(np.median(staged_fps))
    legs["staged"] = {"stage_s": stage_s, "repeats_fps": staged_fps,
                      "median_fps": med, "best_fps": max(staged_fps),
                      "min_fps": min(staged_fps),
                      "ms_per_step_median": batch / med * 1e3 * (
                          n_rest / (len(staged) * engine.chunk)),
                      "frame_steps": steps,
                      "k1_launches": launch_counts()["K1"] - k1_before}
    tracks["staged"] = staged_tracks
    log(f"bench: staged median {med:.1f} fps, best {max(staged_fps):.1f}, "
        f"min {min(staged_fps):.1f}")
    tot = watch.snapshot()
    log(f"bench: kernel totals: {tot['cached']} cached + {tot['built']} "
        f"built ({tot['nvcc_s']:.1f}s nvcc), {tot['loaded']} loaded")
    rec["compile"] = compile_lines

    pos = staged_tracks[-1][0]
    if not np.all(np.isfinite(pos)):
        raise AssertionError("non-finite trajectory")
    fps = stream_fps if mode == "stream" else med
    rec["line"] = {"metric": METRIC, "value": round(fps, 2),
                   "unit": "frames/sec",
                   "vs_baseline": round(fps / BASELINE_FPS, 3)}
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                    "one). `cpu` runs on the CPU")
    ap.add_argument("--json", default=None,
                    help="write the full record to this path")
    return ap.parse_args(argv)


def main(argv=None, env=None):
    from usot_tpu_torch.core.device import resolve_device

    args = parse_args(argv)
    k = knobs(env)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from usot_tpu_torch.tools.timing import card_line

        card = card_line()
    else:
        card = "cpu"
    weights, path, digest = load_weights(k.pop("ckpt"), device)
    rec = run(weights, device, **k)
    rec.pop("tracks")
    rec.update(card=card, weights=path, weights_sha256=digest)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec["line"]), flush=True)
    return rec


if __name__ == "__main__":
    main()
