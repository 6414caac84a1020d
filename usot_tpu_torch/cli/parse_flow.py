"""Pseudo-label factory CLI (counterpart of `usot_tpu/cli/parse_flow.py`;
ref: preprocessing/datasets_train/*/parse_*_flow.py + par_crop.py +
gen_json.py in one pipeline).

    python -m usot_tpu_torch.cli.parse_flow --data_dir <videos> \\
        --output_dir <out> [--dataset got10k|vid|lasot|ytvos] \\
        [--flow_ckpt pwclite_ar_mv.tar] [--keep_all] [--device cpu]

Walks a raw video dataset, runs PWCLite flow + DP box mining per video on
the GPU (`--device cpu` for the CPU; without a GPU and without it, it
raises), writes SiamFC crop511 images and the loader's train.json.
Dataset deltas per the reference: gap=3 everywhere except YTVOS (gap=1,
init_adjacent=1); frame cap 2000; LaSOT 200+20-frame windows.
`main(argv, reader=..., writer=...)` takes the frame reader and the crop
writer (frames held in memory on a machine with no image codec).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
import traceback
from os.path import join

import torch

from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.data import imageio
from usot_tpu_torch.preprocessing.crop_gen import (build_train_json,
                                                   crop_video_frames,
                                                   save_train_json)
from usot_tpu_torch.preprocessing.inference import (FlowHelper,
                                                    inference_sequence,
                                                    load_arflow_checkpoint)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="flow+DP pseudo-label mining")
    p.add_argument("--data_dir", required=True,
                   help="root with one subdir of frames per video")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset", default="got10k",
                   choices=["got10k", "vid", "lasot", "ytvos"])
    p.add_argument("--flow_ckpt", default=None,
                   help="optional pwclite_ar_mv.tar torch checkpoint")
    p.add_argument("--max_frames", type=int, default=2000)
    p.add_argument("--instance_size", type=int, default=511)
    p.add_argument("--limit", type=int, default=0, help="max videos (debug)")
    p.add_argument("--keep_all", action="store_true",
                   help="bypass pseudo-box quality gates (smoke-test "
                   "pipelines with an untrained flow net)")
    p.add_argument("--prohibit", default=None,
                   help="file listing prohibited video names (VOT2020)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; raises without "
                   "one). `cpu` runs on the CPU")
    return p.parse_args(argv)


def video_frame_lists(data_dir: str, dataset: str, max_frames: int):
    videos = sorted(d for d in os.listdir(data_dir)
                    if os.path.isdir(join(data_dir, d)))
    for v in videos:
        frames = sorted(glob.glob(join(data_dir, v, "*.jpg")))
        if not frames:
            frames = sorted(glob.glob(join(data_dir, v, "img", "*.jpg")))
        if not frames:
            frames = sorted(glob.glob(join(data_dir, v, "*.png")))
        if len(frames) < 10:
            continue
        if dataset == "lasot":
            # LaSOT videos are long: 200+20-frame overlapping windows
            # (ref: parse_lasot_flow.py:63-83)
            piece, extend = 200, 20
            split_id = 0
            while True:
                start = split_id * piece
                end = start + piece + extend
                if start >= len(frames):
                    break
                split_id += 1
                if end >= len(frames):
                    end = len(frames) - 1
                    start = max(0, end - piece - extend)
                yield f"{v}-{split_id:02d}", frames[start:end + 1]
        else:
            yield v, frames[:max_frames]


def video_record(bboxs, stats, frame_shape):
    """raw.json's entry of one mined video (one track, "00"):
    `inference_sequence`'s boxes and statistics, the frame's (H, W, C)."""
    freq_dict, _, picked_freq, _, corner_freq = stats
    return {"00": {
        "frames": [list(map(float, b)) for b in bboxs],
        "freq": [[float(f[0]), float(f[1])] for f in freq_dict],
        "meta": {
            "bbox_picked_freq": float(picked_freq),
            "corner_bbox_freq": float(corner_freq),
            "frame_sz": [frame_shape[1], frame_shape[0]],
        },
    }}


def main(argv=None, reader=None, writer=None):
    """Mine every video of `--data_dir`; `reader(path)` (default
    `imageio.read_image`) gives a frame's BGR uint8 array, `writer(path,
    image)` (default `imageio.write_image`) stores a crop."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the flow's numerics are f32: cuDNN defaults to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    reader = reader or imageio.read_image
    gap = 1 if args.dataset == "ytvos" else 3
    init_adjacent = 1 if args.dataset == "ytvos" else 4

    helper = FlowHelper(device=device)
    if args.flow_ckpt and os.path.exists(args.flow_ckpt):
        load_arflow_checkpoint(args.flow_ckpt, helper)

    crop_dir = join(args.output_dir, f"crop{args.instance_size}")
    raw = {}
    n_done = 0
    for video, frames in video_frame_lists(args.data_dir, args.dataset,
                                           args.max_frames):
        if args.limit and n_done >= args.limit:
            break
        t0 = time.time()
        try:
            bboxs, picked, stats = inference_sequence(
                helper, frames, gap=gap, init_adjacent=init_adjacent,
                reader=reader)
        except Exception:
            print(f"video {video} failed; dropped")
            traceback.print_exc()
            continue
        raw[video] = video_record(bboxs, stats, reader(frames[0]).shape)
        crop_video_frames(frames, bboxs, 0, join(crop_dir, video),
                          instance_size=args.instance_size, reader=reader,
                          writer=writer)
        n_done += 1
        print(f"{video}: {len(frames)} frames, picked_freq="
              f"{stats[2]:.3f} ({time.time() - t0:.1f}s)")

    os.makedirs(args.output_dir, exist_ok=True)
    with open(join(args.output_dir, "raw.json"), "w") as f:
        json.dump(raw, f)
    annotations = build_train_json(raw, prohibit_file=args.prohibit,
                                   quality_gate=not args.keep_all)
    save_train_json(annotations, join(args.output_dir, "train.json"))
    print(f"wrote {len(annotations)} videos to train.json")


if __name__ == "__main__":
    main()
