"""SiamFC-style subwindow crops (ref: lib/utils/track_utils.py:30-119).

`get_subwindow` is the host crop of the parity tracker and of the
engines' single-video init. Same padding and geometry as
`usot_tpu.core.crop.get_subwindow`, without OpenCV: the resize is
half-pixel-centre, edge-clamped bilinear (`F.interpolate(mode="bilinear",
align_corners=False)`, what `cv2.resize`'s INTER_LINEAR computes in fixed
point), rounded to uint8. Against `cv2.resize` it differs by at most one
grey level per pixel. Its geometry is `subwindow_geometry`;
`crop_windows` makes its pixels for a batch of lanes on the device (the
batch engine's init).

`subwindow_gather` is the engines' device crop and `subwindow_matmul`
its matmul formulation (`usot_tpu/core/crop.py:109-255`; JAX picks the
gather off the TPU, and so do the engines here): float bilinear, one
window per lane of a (B, H, W, C) frame batch, in one call.

`sample_target_gather` is OSTrack's crop (`sample_target`) for a batch of
lanes on the device: a square window of side ceil(sqrt(w h) * factor),
zero outside the image, resized by OpenCV's INTER_LINEAR arithmetic and
rounded to whole grey levels.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def _resize(win: torch.Tensor, size: int) -> torch.Tensor:
    """(h, w, C) f32 -> (size, size, C) f32, bilinear, no antialias, not
    rounded. The input is laid out (h, w, C), so the (1, C, h, w) view
    is channels-last: the host and the device crops take one CPU kernel.
    (That kernel's summation order depends on the thread count, so this
    call, and no formula written out beside it, is what keeps them
    bitwise equal.)"""
    out = F.interpolate(win.permute(2, 0, 1)[None], size=(size, size),
                        mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0)


def _grey(x: torch.Tensor) -> torch.Tensor:
    """Round to whole grey levels, as a uint8 image holds them."""
    return torch.floor(x + 0.5).clamp_(0, 255)


def resize_bilinear_uint8(patch: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) uint8, bilinear, no antialias."""
    win = torch.from_numpy(np.ascontiguousarray(patch)).to(torch.float32)
    return _grey(_resize(win, size)).to(torch.uint8).numpy()


def subwindow_geometry(im_shape, pos, model_sz, original_sz, target_sz=None,
                       need_bbox=False):
    """The scalar part of `get_subwindow` (same arguments, the image's
    shape for the image): Python's rounding in float64, no pixels.

    Returns (crop_info, window): `get_subwindow`'s crop_info, and
    window = (x0, y0, side), the integer top-left of the square window in
    image coordinates and its side: rows y0 .. y0 + side - 1, columns
    x0 .. x0 + side - 1, the average colour wherever that leaves the
    image."""
    crop_info = {}
    if isinstance(pos, float):
        pos = [pos, pos]

    sz = original_sz
    c = (original_sz + 1) / 2
    context_xmin = round(pos[0] - c)
    context_xmax = context_xmin + sz - 1
    context_ymin = round(pos[1] - c)
    context_ymax = context_ymin + sz - 1
    r, cc = im_shape[0], im_shape[1]
    left_pad = int(max(0.0, -context_xmin))
    top_pad = int(max(0.0, -context_ymin))
    right_pad = int(max(0.0, context_xmax - cc + 1))
    bottom_pad = int(max(0.0, context_ymax - r + 1))
    patch_sz = int(context_ymax + 1) - int(context_ymin)
    window = (int(context_xmin), int(context_ymin), patch_sz)

    context_xmin += left_pad
    context_xmax += left_pad
    context_ymin += top_pad
    context_ymax += top_pad

    if target_sz is not None:
        target_xmin = round(pos[0] - target_sz[0] / 2)
        target_xmax = round(pos[0] + target_sz[0] / 2)
        target_ymin = round(pos[1] - target_sz[1] / 2)
        target_ymax = round(pos[1] + target_sz[1] / 2)
        crop_info["original_image_bbox"] = [target_xmin, target_ymin,
                                            target_xmax, target_ymax]
        if need_bbox:
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
            resized = not np.array_equal(model_sz, original_sz)
            scale_resize = (model_sz if resized else patch_sz) / patch_sz
            crop_info["template_bbox"] = [
                scale_resize * target_xmin_after,
                scale_resize * target_ymin_after,
                scale_resize * target_xmax_after,
                scale_resize * target_ymax_after,
            ]

    crop_info["crop_cords"] = [context_xmin, context_xmax, context_ymin,
                               context_ymax]
    crop_info["pad_info"] = [top_pad, left_pad, r, cc]
    return crop_info, window


def _clip_window(window, h: int, w: int):
    """The part of `window` inside an (h, w) image: (ya, yb, xa, xb),
    empty where ya >= yb or xa >= xb."""
    x0, y0, side = window
    return max(y0, 0), min(y0 + side, h), max(x0, 0), min(x0 + side, w)


def get_subwindow(im, pos, model_sz, original_sz, avg_chans, target_sz=None,
                  need_bbox=False):
    """Crop a square `original_sz` window centred at `pos`, pad with
    avg_chans where the window leaves the image, resize to `model_sz`.

    Returns (patch_hwc_uint8, crop_info dict)."""
    crop_info, window = subwindow_geometry(im.shape, pos, model_sz,
                                           original_sz, target_sz, need_bbox)
    x0, y0, side = window
    ya, yb, xa, xb = _clip_window(window, im.shape[0], im.shape[1])
    if (ya, yb, xa, xb) == (y0, y0 + side, x0, x0 + side):
        im_patch_original = im[ya:yb, xa:xb, :]
    else:
        # the pad holds avg_chans cast to uint8 (truncated)
        im_patch_original = np.empty((side, side, im.shape[2]), np.uint8)
        im_patch_original[:] = avg_chans
        if ya < yb and xa < xb:
            im_patch_original[ya - y0:yb - y0, xa - x0:xb - x0] = \
                im[ya:yb, xa:xb]

    if not np.array_equal(model_sz, original_sz):
        im_patch = resize_bilinear_uint8(im_patch_original, model_sz)
    else:
        im_patch = im_patch_original
    return im_patch, crop_info


def crop_windows(frames, hw, fill, windows, model_sz: int):
    """`get_subwindow`'s pixels for B lanes at once, on the frames'
    device: lane b crops `windows[b]` ((x0, y0, side), from
    `subwindow_geometry`) out of frames[b], a (B, H, W, C) uint8 tensor
    holding lane b's (h, w) = hw[b] image at its top-left; fill (B, C)
    f32 is each lane's pad value (its average colour truncated, as the
    uint8 pad holds it). Each window is resized by `_resize` on its own
    (the windows' sides differ), then all are rounded at once. Returns
    (B, model_sz, model_sz, C) f32 of whole grey levels: bitwise
    `get_subwindow`'s on the CPU."""
    crops = []
    for b, window in enumerate(windows):
        x0, y0, side = window
        win = fill[b].expand(side, side, -1).contiguous()
        ya, yb, xa, xb = _clip_window(window, *hw[b])
        if ya < yb and xa < xb:
            win[ya - y0:yb - y0, xa - x0:xb - x0] = frames[b, ya:yb, xa:xb]
        crops.append(win if side == model_sz else _resize(win, model_sz))
    return _grey(torch.stack(crops))


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


# ---------------------------------------------------------------------------
# OSTrack's crop (lib/train/data/processing_utils.py::sample_target) on the
# device, one window per lane.
# ---------------------------------------------------------------------------

def sample_target_gather(frames, boxes, factor: float, out_sz: int, im_hw):
    """OSTrack's `sample_target` for B lanes at once. frames: (B, H, W, C)
    uint8 on the device, lane b's image at its top-left; boxes: (B, 4)
    float64 [x, y, w, h]; im_hw: (B, 2) each lane's image [h, w].

    The window: side crop_sz = ceil(sqrt(w h) * factor), top-left
    round(centre - crop_sz / 2) (half to even, as Python's `round`),
    in float64 as OSTrack's Python floats. Pixels outside the image read
    zero, and so do the image's last column and last row (OSTrack pads
    `max(x2 - W + 1, 0)` on the right and bottom, which drops them
    whenever the window reaches them). The resize to `out_sz` is
    INTER_LINEAR as float32 arithmetic: src = (dst + 0.5) * crop_sz /
    out_sz - 0.5 clamped at 0, two taps, the far one clamped to the
    window's edge, rounded half up (the repo's host resize, within one
    grey level of `cv2.resize`). Returns ((B, out_sz, out_sz, C) float32
    whole grey levels, crop_sz (B,) float64)."""
    b, h, w, c = frames.shape
    crop_sz = torch.ceil(torch.sqrt(boxes[:, 2] * boxes[:, 3]) * factor)
    x1 = torch.round(boxes[:, 0] + 0.5 * boxes[:, 2] - crop_sz * 0.5)
    y1 = torch.round(boxes[:, 1] + 0.5 * boxes[:, 3] - crop_sz * 0.5)
    steps = torch.arange(out_sz, dtype=torch.float32, device=frames.device)
    src = torch.clamp((crop_sz / out_sz).float()[:, None] * (steps + 0.5)
                      - 0.5, min=0.0)                           # (B, S)
    last = crop_sz.long()[:, None] - 1
    i0 = torch.minimum(src.long(), last)
    i1 = torch.minimum(i0 + 1, last)
    frac = src - i0.float()

    def taps(origin, valid):
        """Image coordinates of both taps (B, S), clamped into the
        frame buffer, and whether each lies in the image's valid part."""
        a, z = origin.long()[:, None] + i0, origin.long()[:, None] + i1
        lim = valid.long()[:, None] - 1       # the last row/column reads 0
        return (a, (a >= 0) & (a < lim)), (z, (z >= 0) & (z < lim))

    (ya, vya), (yb, vyb) = taps(y1, im_hw[:, 0])
    (xa, vxa), (xb, vxb) = taps(x1, im_hw[:, 1])
    flat = frames.reshape(b * h * w, c)
    base = torch.arange(b, device=frames.device)[:, None, None] * (h * w)

    def pixel(yi, vy, xi, vx):
        idx = base + yi.clamp(0, h - 1)[:, :, None] * w \
            + xi.clamp(0, w - 1)[:, None, :]
        val = flat.index_select(0, idx.reshape(-1)).to(torch.float32)
        ok = (vy[:, :, None] & vx[:, None, :])[..., None]
        return torch.where(ok, val.reshape(b, out_sz, out_sz, c), 0.0)

    fx = frac[:, None, :, None]
    fy = frac[:, :, None, None]
    top = (1 - fx) * pixel(ya, vya, xa, vxa) + fx * pixel(ya, vya, xb, vxb)
    bot = (1 - fx) * pixel(yb, vyb, xa, vxa) + fx * pixel(yb, vyb, xb, vxb)
    return _grey((1 - fy) * top + fy * bot), crop_sz
