"""SiamFC-style subwindow crops (ref: lib/utils/track_utils.py:30-119).

`get_subwindow` is the host crop of the parity tracker and of engine
init. Same padding and geometry as `usot_tpu.core.crop.get_subwindow`,
without OpenCV: the resize is half-pixel-centre, edge-clamped bilinear
(`F.interpolate(mode="bilinear", align_corners=False)`, what
`cv2.resize`'s INTER_LINEAR computes in fixed point), rounded to uint8.
Against `cv2.resize` it differs by at most one grey level per pixel.

`subwindow_gather` is the engines' device crop and `subwindow_matmul`
its matmul formulation (`usot_tpu/core/crop.py:109-255`; JAX picks the
gather off the TPU, and so do the engines here): float bilinear, one
window per lane of a (B, H, W, C) frame batch, in one call.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear_uint8(patch: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) uint8, bilinear, no antialias."""
    t = torch.from_numpy(np.ascontiguousarray(patch)).permute(2, 0, 1)
    t = t[None].to(torch.float32)
    out = F.interpolate(t, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=False)
    out = torch.floor(out[0].permute(1, 2, 0) + 0.5).clamp_(0, 255)
    return out.to(torch.uint8).numpy()


def get_subwindow(im, pos, model_sz, original_sz, avg_chans, target_sz=None,
                  need_bbox=False):
    """Crop a square `original_sz` window centred at `pos`, pad with
    avg_chans where the window leaves the image, resize to `model_sz`.

    Returns (patch_hwc_uint8, crop_info dict)."""
    crop_info = {}
    if isinstance(pos, float):
        pos = [pos, pos]

    sz = original_sz
    im_sz = im.shape
    c = (original_sz + 1) / 2
    context_xmin = round(pos[0] - c)
    context_xmax = context_xmin + sz - 1
    context_ymin = round(pos[1] - c)
    context_ymax = context_ymin + sz - 1
    left_pad = int(max(0.0, -context_xmin))
    top_pad = int(max(0.0, -context_ymin))
    right_pad = int(max(0.0, context_xmax - im_sz[1] + 1))
    bottom_pad = int(max(0.0, context_ymax - im_sz[0] + 1))

    context_xmin += left_pad
    context_xmax += left_pad
    context_ymin += top_pad
    context_ymax += top_pad

    r, cc, k = im.shape
    if any([top_pad, bottom_pad, left_pad, right_pad]):
        te_im = np.zeros((r + top_pad + bottom_pad,
                          cc + left_pad + right_pad, k), np.uint8)
        te_im[top_pad:top_pad + r, left_pad:left_pad + cc, :] = im
        if top_pad:
            te_im[0:top_pad, left_pad:left_pad + cc, :] = avg_chans
        if bottom_pad:
            te_im[r + top_pad:, left_pad:left_pad + cc, :] = avg_chans
        if left_pad:
            te_im[:, 0:left_pad, :] = avg_chans
        if right_pad:
            te_im[:, cc + left_pad:, :] = avg_chans
        im_patch_original = te_im[int(context_ymin):int(context_ymax + 1),
                                  int(context_xmin):int(context_xmax + 1), :]
    else:
        im_patch_original = im[int(context_ymin):int(context_ymax + 1),
                               int(context_xmin):int(context_xmax + 1), :]

    if not np.array_equal(model_sz, original_sz):
        im_patch = resize_bilinear_uint8(im_patch_original, model_sz)
    else:
        im_patch = im_patch_original

    if target_sz is not None:
        target_xmin = round(pos[0] - target_sz[0] / 2)
        target_xmax = round(pos[0] + target_sz[0] / 2)
        target_ymin = round(pos[1] - target_sz[1] / 2)
        target_ymax = round(pos[1] + target_sz[1] / 2)
        crop_info["original_image_bbox"] = [target_xmin, target_ymin,
                                            target_xmax, target_ymax]
        if need_bbox:
            patch_sz = im_patch_original.shape[0]
            x_slope = patch_sz / (context_xmax - context_xmin)
            y_slope = patch_sz / (context_ymax - context_ymin)
            target_xmin_after = left_pad - 1 + x_slope * (target_xmin
                                                          - context_xmin)
            target_xmax_after = left_pad - 1 + x_slope * (target_xmax
                                                          - context_xmin)
            target_ymin_after = top_pad - 1 + y_slope * (target_ymin
                                                         - context_ymin)
            target_ymax_after = top_pad - 1 + y_slope * (target_ymax
                                                         - context_ymin)
            scale_resize = im_patch.shape[0] / patch_sz
            crop_info["template_bbox"] = [
                scale_resize * target_xmin_after,
                scale_resize * target_ymin_after,
                scale_resize * target_xmax_after,
                scale_resize * target_ymax_after,
            ]

    crop_info["crop_cords"] = [context_xmin, context_xmax, context_ymin,
                               context_ymax]
    crop_info["pad_info"] = [top_pad, left_pad, r, cc]
    return im_patch, crop_info


# ---------------------------------------------------------------------------
# Device crops for the tracking engines: dynamic windows, one per lane,
# bilinear, avg fill outside the valid region.
# ---------------------------------------------------------------------------

def _window(pos_x, pos_y, original_sz, model_sz: int):
    """Source geometry shared by both device crops (f32, per lane):
    the window's integer top-left and the (B, model_sz) offsets of the
    output pixel centres in it, with cv2's INTER_LINEAR convention
    src = (dst + 0.5) * scale - 0.5. torch.round rounds half to even, as
    jnp.round does."""
    sz = torch.round(original_sz)
    cxt_xmin = torch.round(pos_x - (original_sz + 1.0) / 2.0)
    cxt_ymin = torch.round(pos_y - (original_sz + 1.0) / 2.0)
    scale = sz / float(model_sz)
    steps = torch.arange(model_sz, dtype=torch.float32,
                         device=original_sz.device)
    d = (steps[None, :] + 0.5) * scale[:, None] - 0.5       # (B, S)
    return cxt_xmin[:, None] + d, cxt_ymin[:, None] + d


def _extent(valid, size: int, like):
    if valid is None:
        return torch.full_like(like, float(size))
    return valid


def subwindow_gather(frames, pos_x, pos_y, original_sz, avg_chans,
                     model_sz: int, valid_h=None, valid_w=None,
                     origin=None):
    """Bilinear gather crop of one window per lane (counterpart of
    `usot_tpu.core.crop.subwindow_jax`, which JAX vmaps over lanes).

    frames: (B, H, W, C) uint8 or float; pos_x, pos_y, original_sz: (B,)
    f32; avg_chans: (B, C); valid_h/valid_w: optional (B,) valid extent
    of each lane's canvas (taps outside it read avg_chans).
    origin: optional (B, 2) integer [x, y] image coordinates of each
    lane's buffer's top-left (an ROI window). The tap coordinates are
    computed in image coordinates and the origin is subtracted after,
    which is exact: taps inside the buffer get bitwise the weights of a
    full-frame crop. (Subtracting it from pos first, as JAX does, rounds
    the window's corner differently, by a pixel where it rounds half to
    even across an odd origin.)
    Returns (B, model_sz, model_sz, C) f32. Geometry matches
    `get_subwindow`: the window is [cxt_min, cxt_min + round(sz) - 1]
    with cxt_min = round(pos - (sz + 1) / 2)."""
    b, h, w, c = frames.shape
    src_x, src_y = _window(pos_x, pos_y, original_sz, model_sz)
    if origin is not None:
        src_x = src_x - origin[:, 0:1]
        src_y = src_y - origin[:, 1:2]
    vh = _extent(valid_h, h, pos_x)[:, None]
    vw = _extent(valid_w, w, pos_x)[:, None]

    def taps(coord, size, valid_size):
        c0 = torch.floor(coord)
        frac = coord - c0
        i0 = c0.long()
        i1 = i0 + 1
        ok0 = (i0 >= 0) & (i0 < valid_size)
        ok1 = (i1 >= 0) & (i1 < valid_size)
        return (i0.clamp(0, size - 1), i1.clamp(0, size - 1), frac, ok0, ok1)

    x0, x1, fx, vx0, vx1 = taps(src_x, w, vw)               # (B, S)
    y0, y1, fy, vy0, vy1 = taps(src_y, h, vh)
    flat = frames.reshape(b * h * w, c)
    base = torch.arange(b, device=frames.device)[:, None, None] * (h * w)
    avg = avg_chans.to(torch.float32)[:, None, None, :]

    def pixel(yi, vy, xi, vx):
        idx = base + yi[:, :, None] * w + xi[:, None, :]     # (B, S, S)
        val = flat.index_select(0, idx.reshape(-1)).to(torch.float32)
        val = val.reshape(b, model_sz, model_sz, c)
        ok = (vy[:, :, None] & vx[:, None, :])[..., None]
        return torch.where(ok, val, avg)

    p00 = pixel(y0, vy0, x0, vx0)
    p01 = pixel(y0, vy0, x1, vx1)
    p10 = pixel(y1, vy1, x0, vx0)
    p11 = pixel(y1, vy1, x1, vx1)
    fx = fx[:, None, :, None]
    fy = fy[:, :, None, None]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


@contextlib.contextmanager
def _full_f32_matmul():
    """cuBLAS without TF32 for the block, whatever the global flag says:
    TF32 keeps ~3 decimal digits, ~0.5/255 of a grey level here (the TPU
    twin of this trap is `crop.py`'s Precision.HIGHEST)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def subwindow_matmul(frames, pos_x, pos_y, original_sz, avg_chans,
                     model_sz: int, valid_h=None, valid_w=None):
    """`subwindow_gather` as two batched matmuls (counterpart of
    `usot_tpu.core.crop.subwindow_matmul`):

        out = Ry @ im @ Rx^T + avg * (1 - sy (x) sx)

    Ry (B, S, H) / Rx (B, S, W) hold each output row's / column's two
    bilinear taps, zeroed outside the valid region; sy/sx are their row
    sums. The avg fill separates because a tap is invalid iff its y OR x
    index is: the valid weight mass factors as sy * sx. Same arguments
    and result as `subwindow_gather`; agrees with it within 3e-5."""
    b, h, w, c = frames.shape
    src_x, src_y = _window(pos_x, pos_y, original_sz, model_sz)
    vh = _extent(valid_h, h, pos_x)[:, None, None]
    vw = _extent(valid_w, w, pos_x)[:, None, None]

    def weights(src, size, valid_size):
        i0 = torch.floor(src)
        frac = (src - i0)[..., None]
        i0 = i0[..., None]                                  # (B, S, 1)
        grid = torch.arange(size, dtype=torch.float32,
                            device=src.device)[None, None, :]
        t0 = torch.where((i0 >= 0) & (i0 < valid_size), 1.0 - frac, 0.0)
        t1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < valid_size), frac, 0.0)
        return t0 * (grid == i0) + t1 * (grid == i0 + 1.0)  # (B, S, N)

    ry = weights(src_y, h, vh)
    rx = weights(src_x, w, vw)
    sy = ry.sum(dim=2)
    sx = rx.sum(dim=2)
    with _full_f32_matmul():
        rows = torch.bmm(ry, frames.reshape(b, h, w * c).to(torch.float32))
        rows = rows.reshape(b, model_sz, w, c)
        out = torch.einsum("biwc,bjw->bijc", rows, rx)
    miss = 1.0 - sy[:, :, None, None] * sx[:, None, :, None]
    return out + avg_chans.to(torch.float32)[:, None, None, :] * miss
