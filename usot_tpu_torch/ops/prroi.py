"""Precise RoI Pooling (PrRoIPool) as a separable tent-integral einsum.

Counterpart of `usot_tpu/ops/prroi.py` (ref CUDA op:
lib/models/prroi_pool/src/prroi_pooling_gpu_impl.cu:149-212). The bilinear
interpolant is a sum of separable tent functions on the integer grid, so
the average over an axis-aligned bin factorises into two small products:

    out[ph, pw] = (1 / bin_area) * sum_{h,w} F[h, w] * Iy[ph, h] * Ix[pw, w]

Autograd gives both the feature gradient and the RoI-coordinate gradient.
Out-of-image tent mass multiplies implicit zeros (the CUDA op's
zero padding); a zero-area RoI pools to zeros.
"""
from __future__ import annotations

import torch


def _tent_antiderivative(s):
    """Integral of tent(t) = max(0, 1-|t|), shifted so G(-1) = -0.5 and
    G(1) = 0.5 (only differences are used)."""
    t = torch.clamp(s, -1.0, 1.0)
    return t - 0.5 * t * torch.abs(t)


def _axis_integrals(start, end, n_bins: int, size: int):
    """(R,) bounds -> (R, n_bins, size) integrals of each grid tent over
    each of n_bins equal bins of [start, end]."""
    bin_sz = (end - start) / n_bins
    p = torch.arange(n_bins, dtype=start.dtype, device=start.device)
    lo = start[:, None] + bin_sz[:, None] * p
    hi = lo + bin_sz[:, None]
    g = torch.arange(size, dtype=start.dtype, device=start.device)
    return (_tent_antiderivative(hi[..., None] - g)
            - _tent_antiderivative(lo[..., None] - g))


def prroi_pool(features, rois, pooled_height: int = 7, pooled_width: int = 7,
               spatial_scale: float = 1.0):
    """features: (N, H, W, C); rois: (R, 5) rows (batch_index, x1, y1, x2,
    y2) in input coordinates. Returns (R, pooled_height, pooled_width, C)."""
    _, h, w, _ = features.shape
    rois = rois.to(features.dtype)
    batch_idx = rois[:, 0].long()
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale

    roi_w = torch.clamp(x2 - x1, min=0.0)
    roi_h = torch.clamp(y2 - y1, min=0.0)
    # Integrate over [x1, x1 + roi_w] so degenerate rois keep zero width
    ix = _axis_integrals(x1, x1 + roi_w, pooled_width, w)    # (R, PW, W)
    iy = _axis_integrals(y1, y1 + roi_h, pooled_height, h)   # (R, PH, H)

    f = features[batch_idx]                                  # (R, H, W, C)
    tmp = torch.einsum("rhwc,rph->rpwc", f, iy)
    out = torch.einsum("rpwc,rqw->rpqc", tmp, ix)

    bin_area = (roi_w / pooled_width) * (roi_h / pooled_height)
    positive = bin_area > 0
    safe = torch.where(positive, bin_area, torch.ones_like(bin_area))
    out = out / safe[:, None, None, None]
    return torch.where(positive[:, None, None, None], out,
                       torch.zeros_like(out))


def prroi_pool_same_batch(features, boxes, pooled: int = 7,
                          spatial_scale: float = 1.0):
    """One RoI per feature map (the only pattern USOT uses).
    features: (N, H, W, C); boxes: (N, 4) [x1, y1, x2, y2]."""
    n = features.shape[0]
    idx = torch.arange(n, dtype=features.dtype,
                       device=features.device)[:, None]
    rois = torch.cat([idx, boxes.to(features.dtype)], dim=1)
    return prroi_pool(features, rois, pooled, pooled, spatial_scale)
