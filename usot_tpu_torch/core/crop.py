"""SiamFC-style host subwindow crop (ref: lib/utils/track_utils.py:30-119).

Same padding and geometry as `usot_tpu.core.crop.get_subwindow`, without
OpenCV: the resize is half-pixel-centre, edge-clamped bilinear
(`F.interpolate(mode="bilinear", align_corners=False)`, what
`cv2.resize`'s INTER_LINEAR computes in fixed point), rounded to uint8.
Against `cv2.resize` it differs by at most one grey level per pixel.
"""
from __future__ import annotations

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
