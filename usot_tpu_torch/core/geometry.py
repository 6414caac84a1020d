"""Grids and coordinate transforms shared by the model and the tracker.

The port's own copy of the helpers it needs from
`usot_tpu/core/geometry.py` (numpy only; ref: lib/models/models.py:102-162,
lib/tracker/usot_tracker.py:287-350).
"""
from __future__ import annotations

import numpy as np


def score_grid(score_size: int, stride: int, search_size: int):
    """Image-axis (x, y) coordinate of every response-map cell.

    Returns two (score_size, score_size) float32 arrays. Cell (i, j) maps
    to pixel ((j - sz//2)*stride + search_size//2,
    (i - sz//2)*stride + search_size//2)."""
    half = score_size // 2
    x, y = np.meshgrid(np.arange(0, score_size) - float(half),
                       np.arange(0, score_size) - float(half))
    gx = x * stride + search_size // 2
    gy = y * stride + search_size // 2
    return gx.astype(np.float32), gy.astype(np.float32)


def feature_axis(feat_size: int, stride: int, image_size: int) -> np.ndarray:
    """1-D image-axis coordinates of a feature map's cells (shared x/y)."""
    half = feat_size // 2
    return ((np.arange(0, feat_size) - float(half)) * stride
            + image_size // 2).astype(np.float32)


def image_bbox_to_pool_bbox(bbox, axis: np.ndarray, feat_size: int,
                            clip_gap: float = 0.0):
    """Affine-map an image-axis [x1,y1,x2,y2] bbox onto the feature axis.

    clip_gap is how far (in feature cells) outside [axis[0], axis[-1]]
    the bbox may reach before clipping: 0 for template labels, 1 for the
    tracker's memory extraction."""
    reg_min = float(axis[0])
    reg_max = float(axis[-1])
    sz = 2 * (feat_size // 2)
    slope = sz / (reg_max - reg_min)
    gap = 1.0 / slope
    bbox = np.asarray(bbox, np.float32)
    bbox = np.clip(bbox, reg_min - clip_gap * gap, reg_max + clip_gap * gap)
    return (bbox - reg_min) * slope


def python2round(f: float) -> float:
    """Python-2 style round-half-away-from-zero (ref: track_utils.py:121)."""
    if round(f + 1) - round(f) != 1:
        return f + abs(f) / f * 0.5
    return round(f)
