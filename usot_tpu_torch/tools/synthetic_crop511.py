"""`tools/train_synthetic.py`'s dataset, made in memory: crop511 videos
of a solid coloured square over one noise image per video, with the
annotation JSON the training dataset reads. No OpenCV and no image
files: the frames are handed to `USOTDataset` through its reader, as the
card (which has no image decoder) needs.

The draws are `gen_dataset`'s own, in its order (`tools/train_synthetic.
py:21-51`), so the frames are its arrays; JAX's trainer reads them back
from the JPEGs `gen_dataset` writes, which differ from the arrays by the
JPEG encoding.
"""
from __future__ import annotations

import json
import os

import numpy as np


def gen_dataset(root: str, n_videos: int = 24, n_frames: int = 12,
                seed: int = 0):
    """Writes `<root>/train.json` and returns (crop_dir, annotation path,
    reader): `reader(path)` gives the BGR uint8 511x511 frame that
    `gen_dataset` would have written at `path`."""
    crop_dir = os.path.join(root, "crop511")
    rng = np.random.default_rng(seed)
    frames, ann = {}, {}
    for v in range(n_videos):
        name = f"vid_{v:03d}"
        vdir = os.path.join(crop_dir, name)
        base = (rng.random((511, 511, 3)) * 255).astype(np.uint8)
        color = rng.integers(60, 255, 3)
        size = int(rng.integers(60, 140))
        cx, cy = 255.0, 255.0  # crop511 layout centers the target
        track = {}
        for f in range(n_frames):
            im = base.copy()
            # mild appearance jitter so the tracker learns invariance
            jitter = rng.integers(-10, 10, 3)
            c = np.clip(color + jitter, 0, 255)
            x1 = int(cx - size / 2)
            y1 = int(cy - size / 2)
            im[y1:y1 + size, x1:x1 + size] = c
            frames[os.path.join(vdir, f"{f:06d}.00.x.jpg")] = im
            track[str(f)] = [cx - size / 2, cy - size / 2,
                             cx + size / 2, cy + size / 2, 0.9, 0.8,
                             max(0, f - 4), min(n_frames - 1, f + 4), 0.0]
        track["meta"] = {"bbox_picked_freq": 0.9, "corner_bbox_freq": 0.05}
        ann[name] = {"00": track}
    os.makedirs(root, exist_ok=True)
    ann_path = os.path.join(root, "train.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)

    def reader(path):
        return frames.get(os.path.normpath(path))

    return crop_dir, ann_path, reader


def use_dataset(cfg, crop_dir: str, ann_path: str, samples: int):
    """Point `cfg`'s training data at the dataset (`train_synthetic.py`'s
    GOT10K entry): `samples` samples per epoch."""
    cfg.USOT.TRAIN.WHICH_USE = ["GOT10K"]
    got = cfg.USOT.DATASET.GOT10K
    got.PATH = crop_dir + "/"
    got.ANNOTATION = ann_path
    got.USE = samples
    return cfg
