"""VOT region overlap: ctypes binding to the native C++ kernel with a
pure-NumPy mirror of the identical algorithm.

The port's own copy of `vot_overlap` and what it needs from
`usot_tpu/eval/region.py` (ref: lib/eval_toolkit/pysot/utils/src/region.c,
region.pyx): host code, called by `poly_iou` for non-convex polygons and
by the evaluation statistics (`vot_overlap_traj`).
The C++ source is the repo's `native/region/region.cpp`, built with g++
on first use into the port's git-ignored `_build/`; where it cannot be
built or loaded, the NumPy mirror computes the same overlap.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "region", "region.cpp")
_BUILD_DIR = os.path.join(_ROOT, "usot_tpu_torch", "_build")
_LIB = None
_LIB_TRIED = False


def _build_and_load():
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_BUILD_DIR, "libregion.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(_SOURCE)):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            # build under a name of this process, then rename: parallel
            # test workers never load a half-written library
            tmp = f"{so}.{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SOURCE],
                check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.region_polygon_overlap.restype = ctypes.c_float
        lib.region_polygon_overlap.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


# ---------------------------------------------------------------------------
# NumPy mirror of the same scanline algorithm (tested against the C++).
# ---------------------------------------------------------------------------

def _rasterize_np(x, y, width, height):
    x = np.round(np.asarray(x, np.float64))
    y = np.round(np.asarray(y, np.float64))
    n = len(x)
    mask = np.zeros((height, width), np.uint8)
    yi = y.astype(np.int64)
    for row in range(height):
        nodes = []
        j = n - 1
        for i in range(n):
            a, b = yi[i], yi[j]
            if ((a <= row < b) or (b <= row < a)
                    or (a < row <= b) or (b < row <= a)
                    or (a == b == row)):
                r = y[j] - y[i]
                if r != 0.0:
                    nodes.append(int(x[i] + (row - y[i]) / r * (x[j] - x[i])))
            j = i
        nodes.sort()
        i = 0
        while i + 1 < len(nodes):
            if nodes[i] == nodes[i + 1]:
                i += 1
                continue
            if nodes[i] >= width:
                break
            if nodes[i + 1] >= 0:
                lo = max(nodes[i], 0)
                hi = min(nodes[i + 1], width - 1)
                mask[row, lo:hi + 1] = 1
            i += 2
    return mask


def _overlap_np(p1, p2, bounds):
    # float32 throughout, matching the reference's region_polygon storage
    # (ref: src/region.c — coords are float; see native/region/region.cpp)
    x1 = np.asarray(p1[0::2], np.float32)
    y1 = np.asarray(p1[1::2], np.float32)
    x2 = np.asarray(p2[0::2], np.float32)
    y2 = np.asarray(p2[1::2], np.float32)
    f32 = np.float32
    b_top, b_bottom, b_left, b_right = [f32(b) for b in bounds]

    def rb(x, y):
        return (max(f32(np.floor(y.min())), b_top),
                min(f32(np.ceil(y.max())), b_bottom),
                max(f32(np.floor(x.min())), b_left),
                min(f32(np.ceil(x.max())), b_right))

    t1, bo1, l1, r1 = rb(x1, y1)
    t2, bo2, l2, r2 = rb(x2, y2)

    ox = min(l1, l2)
    oy = min(t1, t2)
    width = int(max(r1, r2) - ox) + 1
    height = int(max(bo1, bo2) - oy) + 1
    a1 = float((r1 - l1) * (bo1 - t1))
    a2 = float((r2 - l2) * (bo2 - t2))
    with np.errstate(divide="ignore", invalid="ignore"):
        # IEEE semantics like the reference: inf/nan comparisons resolve
        # the degenerate-area branches (ref region.c:884-895)
        g1 = np.float64(a1) / np.float64(a2) < 1e-10
        g2 = np.float64(a2) / np.float64(a1) < 1e-10
    if g1 or g2 or width < 1 or height < 1:
        return 0.0
    # float bbox-IoU == 0 test (edge-touching boxes count as disjoint),
    # ref region.c:671-679
    it = max(t1, t2)
    ib = min(bo1, bo2)
    il = max(l1, l2)
    ir = min(r1, r2)
    inter = f32((ir - il) * (ib - it))
    denom = f32((r1 - l1) * (bo1 - t1) + (r2 - l2) * (bo2 - t2) - inter)
    if max(np.float32(0.0), inter / denom) == 0.0:
        return 0.0

    m1 = _rasterize_np(x1 - ox, y1 - oy, width, height)
    m2 = _rasterize_np(x2 - ox, y2 - oy, width, height)
    inter = int(np.sum((m1 & m2) > 0))
    union = int(np.sum((m1 | m2) > 0))
    return 0.0 if union == 0 else inter / union


# ---------------------------------------------------------------------------
# Public API (region.pyx-compatible)
# ---------------------------------------------------------------------------

def _to_polygon(region) -> Optional[np.ndarray]:
    """rect [x,y,w,h] or polygon [x0,y0,...] -> flat polygon array."""
    region = np.asarray(region, np.float64).ravel()
    if len(region) == 1:
        return None
    if len(region) == 4:
        x, y, w, h = region
        return np.array([x, y, x + w, y, x + w, y + h, x, y + h], np.float64)
    return region


def _bounds_tuple(bounds):
    if bounds is not None and len(bounds) == 4:
        # (left, top, right, bottom) -> top/bottom/left/right
        return (bounds[1], bounds[3], bounds[0], bounds[2])
    if bounds is not None and len(bounds) == 2:
        # (width, height): top=0, bottom=height, left=0, right=width
        return (0.0, float(bounds[1]), 0.0, float(bounds[0]))
    return (-np.inf, np.inf, -np.inf, np.inf)


def vot_overlap(polygon1, polygon2, bounds=None) -> float:
    p1 = _to_polygon(polygon1)
    p2 = _to_polygon(polygon2)
    if p1 is None or p2 is None:
        return float("nan")
    bt = _bounds_tuple(bounds)

    lib = _build_and_load()
    if lib is not None:
        c1 = p1.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        c2 = p2.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        return float(lib.region_polygon_overlap(
            c1, len(p1) // 2, c2, len(p2) // 2,
            ctypes.c_double(bt[0]), ctypes.c_double(bt[1]),
            ctypes.c_double(bt[2]), ctypes.c_double(bt[3])))
    return float(_overlap_np(p1, p2, bt))



def vot_overlap_traj(polygons1: Sequence, polygons2: Sequence,
                     bounds=None) -> List[float]:
    assert len(polygons1) == len(polygons2)
    return [vot_overlap(polygons1[i], polygons2[i], bounds=bounds)
            for i in range(len(polygons1))]


def vot_float2str(template: str, value: float) -> str:
    return template % value
