"""Exact polygon IoU (ref: lib/utils/test_utils.py:34-87 used shapely).

The port's own copy of `usot_tpu/eval/polygon.py`.

Shapely is not in the image; for the VOT restart check we compute the
exact intersection of two convex polygons with Sutherland-Hodgman clipping
(VOT gt quadrilaterals are convex). Falls back to the rasterized region
overlap if a polygon is non-convex.
"""
from __future__ import annotations

import numpy as np


def _to_points(region):
    region = np.asarray(region, np.float64).ravel()
    if len(region) == 4:
        x, y, w, h = region
        return np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
    return region.reshape(-1, 2)


def _poly_area(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * np.abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _is_convex(pts):
    n = len(pts)
    if n < 4:
        return True
    sign = 0
    for i in range(n):
        a, b, c = pts[i], pts[(i + 1) % n], pts[(i + 2) % n]
        cross = (b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0])
        if abs(cross) < 1e-12:
            continue
        s = 1 if cross > 0 else -1
        if sign == 0:
            sign = s
        elif s != sign:
            return False
    return True


def _clip(subject, cp1, cp2):
    """Clip subject polygon by the half-plane left of edge cp1->cp2."""
    def inside(p):
        return ((cp2[0] - cp1[0]) * (p[1] - cp1[1])
                - (cp2[1] - cp1[1]) * (p[0] - cp1[0])) >= 0

    def intersection(s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        d = dc[0] * dp[1] - dc[1] * dp[0]
        if d == 0:
            return e
        return ((n1 * dp[0] - n2 * dc[0]) / d, (n1 * dp[1] - n2 * dc[1]) / d)

    out = []
    s = subject[-1]
    for e in subject:
        if inside(e):
            if not inside(s):
                out.append(intersection(s, e))
            out.append(tuple(e))
        elif inside(s):
            out.append(intersection(s, e))
        s = e
    return out


def _ensure_ccw(pts):
    x, y = pts[:, 0], pts[:, 1]
    signed = np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
    return pts if signed > 0 else pts[::-1]


def poly_iou(polys1, polys2, bound=None) -> float:
    """Exact IoU between two rects/quads; bound optionally clips both
    to [0, bound_w] x [0, bound_h]."""
    p1 = _to_points(polys1)
    p2 = _to_points(polys2)

    if bound is not None:
        bw, bh = float(bound[0]), float(bound[1])
        bound_poly = [[0, 0], [bw, 0], [bw, bh], [0, bh]]

        def clip_to_bound(p):
            pts = list(map(tuple, _ensure_ccw(p)))
            bp = bound_poly
            for i in range(4):
                pts = _clip(pts, bp[i], bp[(i + 1) % 4])
                if not pts:
                    return None
            return np.asarray(pts)

        p1c = clip_to_bound(p1)
        p2c = clip_to_bound(p2)
        if p1c is None or p2c is None:
            return 0.0
        p1, p2 = p1c, p2c

    if not (_is_convex(p1) and _is_convex(p2)):
        from usot_tpu_torch.eval.region import vot_overlap
        return float(np.nan_to_num(vot_overlap(
            np.asarray(polys1, np.float64).ravel(),
            np.asarray(polys2, np.float64).ravel())))

    a1 = _poly_area(p1)
    a2 = _poly_area(p2)
    if a1 <= 0 or a2 <= 0:
        return 0.0

    subject = list(map(tuple, _ensure_ccw(p1)))
    clipper = _ensure_ccw(p2)
    n = len(clipper)
    for i in range(n):
        subject = _clip(subject, clipper[i], clipper[(i + 1) % n])
        if not subject:
            return 0.0
    inter = _poly_area(np.asarray(subject))
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0
