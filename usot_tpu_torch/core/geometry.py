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


def cxy_wh_2_rect(pos, sz):
    """Center+size -> 0-indexed [x, y, w, h] rect."""
    return np.array(
        [pos[0] - sz[0] / 2, pos[1] - sz[1] / 2, sz[0], sz[1]], dtype=np.float64
    )


def rect_2_cxy_wh(rect):
    return (
        np.array([rect[0] + rect[2] / 2, rect[1] + rect[3] / 2]),
        np.array([rect[2], rect[3]]),
    )


def get_axis_aligned_bbox(region):
    """VOT polygon (8 numbers) or rect (4) -> axis-aligned (cx, cy, w, h).

    Area-preserving scaling of the polygon bound (ref: lib/utils/test_utils.py:10-32).
    """
    region = np.asarray(region, dtype=np.float64)
    nv = region.size
    if nv == 8:
        cx = np.mean(region[0::2])
        cy = np.mean(region[1::2])
        x1 = min(region[0::2])
        x2 = max(region[0::2])
        y1 = min(region[1::2])
        y2 = max(region[1::2])
        A1 = np.linalg.norm(region[0:2] - region[2:4]) * np.linalg.norm(
            region[2:4] - region[4:6]
        )
        A2 = (x2 - x1) * (y2 - y1)
        s = np.sqrt(A1 / A2)
        w = s * (x2 - x1) + 1
        h = s * (y2 - y1) + 1
    else:
        x = region[0]
        y = region[1]
        w = region[2]
        h = region[3]
        cx = x + w / 2
        cy = y + h / 2
    return cx, cy, w, h
