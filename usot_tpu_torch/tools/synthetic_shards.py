"""Synthetic training data in `usot_tpu`'s dataset layout, and the shard
sets `data.shards.write_shards` writes from it, with no OpenCV and no
image files: what the card trains on when it has no dataset
(`chip_smoke.py` phase 10, `tools.measure_bf16_drift`), the counterpart
of `tools/train_synthetic.py`'s moving squares over noise.

A sample is a textured square on uniform noise, centred in the 127
template and shifted by up to 24 px in the 255 search image (and in each
memory frame), with the label disk, regression targets and pool boxes
of `usot_tpu/data/dataset.py:127-158,270-292` for that box.
"""
from __future__ import annotations

import os

import numpy as np

from usot_tpu_torch.core.geometry import feature_axis, score_grid
from usot_tpu_torch.data.shards import epoch_dir, write_shards

TEMPLATE, SEARCH, SCORE, STRIDE = 127, 255, 25, 8


def _pool_label(bbox, feat_size, image_size):
    """`usot_tpu/data/dataset.py:137-147`: an image box on a feature axis
    of `feat_size` cells, clipped to the axis."""
    axis = feature_axis(feat_size, STRIDE, image_size)
    lo, hi = float(axis[0]), float(axis[-1])
    box = np.clip(np.asarray(bbox, np.float32), lo, hi)
    return ((box - lo) * (2 * (feat_size // 2) / (hi - lo))).astype(
        np.float32)


def training_sample(rng, cycle_memory, mem=4, box=64):
    """One training sample in `usot_tpu`'s dataset layout: a textured
    `box`-px square on uniform noise, centred in the 127 template and
    shifted by up to 24 px in the 255 search image (and in each of `mem`
    memory frames), with the label disk, regression targets and pool
    boxes of `usot_tpu/data/dataset.py:127-158,270-292` for that box.
    Float HWC images, as a dataset yields them."""
    def image(size, dx, dy):
        im = rng.random((size, size, 3)) * 255.0
        x1, y1 = size // 2 - box // 2 + dx, size // 2 - box // 2 + dy
        im[y1:y1 + box, x1:x1 + box] = np.array([200.0, 180.0, 60.0]) \
            + rng.normal(0.0, 40.0, (box, box, 3))
        return (np.clip(np.round(im), 0, 255).astype(np.float32),
                np.array([x1, y1, x1 + box, y1 + box], np.float32))

    template, bt = image(TEMPLATE, 0, 0)
    dx, dy = (int(v) for v in rng.integers(-24, 25, size=2))
    search, bs = image(SEARCH, dx, dy)
    gx, gy = score_grid(SCORE, STRIDE, SEARCH)
    reg = np.stack([gx - bs[0], gy - bs[1], bs[2] - gx, bs[3] - gy], -1)
    half = SCORE // 2
    x, y = np.meshgrid(np.arange(SCORE) - float(half + int(dx / STRIDE)),
                       np.arange(SCORE) - float(half + int(dy / STRIDE)))
    sample = {
        "template": template, "search": search,
        "label": (np.abs(x) + np.abs(y) <= 2).astype(np.float32),
        "reg_target": reg.astype(np.float32),
        "reg_weight": (reg.min(-1) > 0).astype(np.float32),
        "template_bbox": _pool_label(bt, 15, TEMPLATE)}
    if cycle_memory:
        sample["search_memory"] = np.stack([
            image(SEARCH, *(int(v) for v in rng.integers(-24, 25, size=2)))
            [0] for _ in range(mem)])
        sample["search_bbox"] = _pool_label(bs, SCORE, SEARCH)
    return sample


class SyntheticSamples:
    """`n` seeded `training_sample`s in the dataset protocol
    `data.shards.write_shards` reads (len, index, cycle_memory, seed)."""

    def __init__(self, n, cycle_memory, mem, seed):
        self.n, self.cycle_memory, self.mem, self.seed = \
            n, cycle_memory, mem, seed

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        return training_sample(np.random.default_rng((self.seed, index)),
                               self.cycle_memory, self.mem)


def write_training_shards(root, end_epoch, memory_epoch, n_samples, mem,
                          seed=0):
    """A shard set for epochs 1..end_epoch under `root` (naive samples
    before `memory_epoch`, cycle-memory ones from it), in the format of
    `usot_tpu.cli.make_shards`. Returns its size in bytes."""
    for epoch in range(1, end_epoch + 1):
        write_shards(SyntheticSamples(n_samples, epoch >= memory_epoch, mem,
                                      seed + epoch),
                     epoch_dir(root, epoch), shard_size=n_samples)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)
