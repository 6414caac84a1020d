"""bfloat16 drift on weights trained on the card: trajectories of the scan
engine in float32 against bfloat16.

    python -m usot_tpu_torch.tools.measure_bf16_drift [--out var/bf16_drift]

The counterpart of `tools/train_synthetic.py` followed by
`tools/measure_bf16_drift.py`, with the same schedule on other data.
Random weights make any drift figure meaningless (their argmax is
chance-level), so it first trains:

1. writes a seeded synthetic shard set (`tools.synthetic_shards`) for
   every epoch. These are not `tools/train_synthetic.py`'s data (solid
   coloured squares of 60-140 px on one noise image per video, cropped
   and augmented by the live loader, which the port lacks): a 64-px
   textured square on fresh noise, shifted by up to 24 px, no OpenCV;
2. trains a model in float32 through `cli.train.train` on the schedule
   of `tools/train_synthetic.py`: 7 epochs, naive Siamese until epoch 6
   and cycle memory (2 memory frames) from it, layers 1-3 unfrozen from
   epoch 3, batch 8 then 4, from scratch, on `--samples` samples per
   epoch (400 by default, as JAX's; on these data the weights then
   barely track the video, and `--samples 1200` gives weights that do);
3. saves the trained state dict as `<out>/usot_synthetic.pth`;
4. tracks one synthetic 480x640 video (`tracker.engine.synthetic_video`,
   `bench.py`'s recipe) with `ScanEngine` (K1 on the card) in float32
   and in bfloat16 from the same weights.

Prints, and writes to `--json`, the center, size and score deviation
between the two trajectories (mean, p95, max) and each one's center
error against the video's ground truth, with the card's name and power
limit. Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="var/bf16_drift",
                    help="training logs, checkpoints and the trained .pth")
    ap.add_argument("--json", default="chiprun_out/bf16_drift.json")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--samples", type=int, default=400,
                    help="samples per epoch")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                    "one). `cpu` runs on the CPU")
    return ap.parse_args(argv)


# `tools/train_synthetic.py`'s schedule: epochs, batch (halved for cycle
# memory), memory frames
EPOCHS, BATCH, MEMORY_FRAMES = 7, 8, 2


def training_config(args):
    """`tools/train_synthetic.py`'s overrides of the default recipe."""
    from usot_tpu_torch.config.defaults import load_config

    cfg = load_config(None)
    cfg.OUTPUT_DIR = os.path.join(args.out, "log")
    cfg.CHECKPOINT_DIR = os.path.join(args.out, "snapshot")
    cfg.PRINT_FREQ = 10
    tc = cfg.USOT.TRAIN
    tc.WIDTH, tc.CHANNELS = args.width, args.channels
    tc.START_EPOCH, tc.END_EPOCH = 1, EPOCHS
    tc.BATCH, tc.BATCH_STAGE_2 = BATCH, BATCH // 2
    tc.MEMORY_EPOCH, tc.UNFIX_EPOCH, tc.MEMORY_NUM = 6, 3, MEMORY_FRAMES
    tc.PRETRAIN = "nonexistent.model"
    return cfg


def ground_truth(n_frames: int):
    """Centre of frame f of `tracker.engine.synthetic_video`."""
    f = np.arange(n_frames)
    tri = 32 - np.abs(f % 64 - 32)
    return np.stack([200 + np.floor(1.5 * tri), 240 + np.floor(0.7 * tri)],
                    -1).astype(np.float64)


def _stats(d):
    return {"mean": float(d.mean()), "p95": float(np.percentile(d, 95)),
            "max": float(d.max())}


def track(state_dict, dtype, frames, device, mem, width, channels):
    """`ScanEngine` on `frames` from `state_dict` in compute `dtype`.
    Returns (positions, sizes, scores, seconds)."""
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.tracker.config import TrackerConfig
    from usot_tpu_torch.tracker.engine import ScanEngine
    from usot_tpu_torch.tracker.runner import ModelRunner

    model = build_usot(mem_size=mem, width=width, channels=channels,
                       fused_xcorr=True, dtype=dtype)
    runner = ModelRunner(model, state_dict, device=device)
    p = TrackerConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    h, w = frames[0].shape[:2]
    engine = ScanEngine(model, p, im_h=h, im_w=w,
                        max_frames=len(frames) + 8, chunk=32, device=device)
    state = engine.init_state(frames[0], np.array([200.0, 240.0]),
                              np.array([60.0, 60.0]), runner)
    t0 = time.perf_counter()
    _, pos, sz, score = engine.track_frames(state, np.stack(frames[1:]))
    return pos, sz, score, time.perf_counter() - t0


def main(argv=None):
    from usot_tpu_torch.cli.train import parse_args as train_args
    from usot_tpu_torch.cli.train import train
    from usot_tpu_torch.core.device import resolve_device
    from usot_tpu_torch.tools.synthetic_shards import write_training_shards
    from usot_tpu_torch.tools.timing import card_line
    from usot_tpu_torch.tracker.engine import synthetic_video

    args = parse_args(argv)
    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    mem = MEMORY_FRAMES
    cfg = training_config(args)
    rec = {"card": card, "device": str(device),
           "recipe": {"epochs": EPOCHS, "samples": args.samples,
                      "batch": BATCH, "memory_frames": mem,
                      "width": args.width, "channels": args.channels}}
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.out) as shards:
        t0 = time.perf_counter()
        rec["shard_bytes"] = write_training_shards(
            shards, EPOCHS, cfg.USOT.TRAIN.MEMORY_EPOCH, args.samples, mem)
        rec["shard_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        record = train(cfg, train_args(["--shards", shards]), device)
        rec["train_s"] = time.perf_counter() - t0
    rec["loss_avg"] = {e: r["loss_avg"] for e, r in record["epochs"].items()}
    # the trained weights: the last epoch's checkpoint
    last = record["epochs"][str(EPOCHS)]["checkpoint"]
    state = torch.load(last, map_location="cpu",
                       weights_only=True)["state_dict"]
    rec["checkpoint"] = os.path.join(args.out, "usot_synthetic.pth")
    torch.save(state, rec["checkpoint"])

    frames = synthetic_video(args.frames)
    gt = ground_truth(args.frames)[1:]
    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pos, sz, score, secs = track(state, dtype, frames, device, mem,
                                     args.width, args.channels)
        runs[name] = (pos, sz, score)
        rec[f"track_{name}_s"] = secs
        rec[f"center_error_vs_gt_{name}"] = _stats(
            np.linalg.norm(pos - gt, axis=1))
    (p32, s32, c32), (p16, s16, c16) = runs["f32"], runs["bf16"]
    rec["center_deviation_px"] = _stats(np.linalg.norm(p32 - p16, axis=1))
    rec["size_deviation_px"] = _stats(np.linalg.norm(s32 - s16, axis=1))
    rec["score_deviation"] = _stats(np.abs(c32 - c16))
    rec["frames_tracked"] = len(p32)
    e32 = rec["center_error_vs_gt_f32"]["mean"]
    e16 = rec["center_error_vs_gt_bf16"]["mean"]
    rec["bf16_error_within_25pct_of_f32"] = bool(e16 <= 1.25 * e32)
    line = json.dumps({"bf16_drift": rec})
    print(line, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
