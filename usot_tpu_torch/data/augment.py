"""Stateless image augmentations for the training loader: the port's copy
of `usot_tpu/data/augment.py` over `data/cvops.py` instead of OpenCV
(ref: lib/dataset_loader/datasets_usot.py:71-95).

  template: fliplr(p=.4), flipud(p=.2), perspective(0.01-0.07),
            coarse dropout, salt&pepper
  search:   hue/saturation x(0.5-1.5 per channel), brightness x(0.5-1.5),
            motion blur (k 3-9, angle +-60)
  memory:   both groups

Geometric ops also transform the box (corners projected, the
axis-aligned envelope taken, like imgaug). Every random choice comes from
the passed `numpy.random.Generator` with JAX's calls in JAX's order, so
the same generator gives the same samples and leaves the same state.
"""
from __future__ import annotations

import numpy as np

from usot_tpu_torch.data import cvops


def _project_bbox(H, bbox):
    x1, y1, x2, y2 = bbox
    pts = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float64)
    ones = np.ones((4, 1))
    hom = np.concatenate([pts, ones], axis=1) @ H.T
    hom = hom[:, :2] / hom[:, 2:3]
    return [hom[:, 0].min(), hom[:, 1].min(), hom[:, 0].max(), hom[:, 1].max()]


def fliplr(image, bbox):
    w = image.shape[1]
    x1, y1, x2, y2 = bbox
    return image[:, ::-1].copy(), [w - x2, y1, w - x1, y2]


def flipud(image, bbox):
    h = image.shape[0]
    x1, y1, x2, y2 = bbox
    return image[::-1].copy(), [x1, h - y2, x2, h - y1]


def perspective(image, bbox, rng, scale=(0.01, 0.07)):
    """Random projective warp: corners jittered by N(0, s*size)."""
    h, w = image.shape[:2]
    s = rng.uniform(*scale)
    jitter = rng.normal(0, s, (4, 2)) * [w, h]
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    dst = (src + jitter).astype(np.float32)
    H = cvops.perspective_transform(src, dst)
    out = cvops.warp_perspective(image, H, (w, h))
    return out, _project_bbox(H, bbox)


def coarse_dropout(image, rng, p=(0.0, 0.05), size_percent=0.15,
                   per_channel_p=0.5):
    """Drop rectangular cells of a coarse grid to 0."""
    h, w = image.shape[:2]
    drop_p = rng.uniform(*p)
    if drop_p <= 0:
        return image
    gh = max(2, int(h * size_percent))
    gw = max(2, int(w * size_percent))
    out = image.copy()
    if rng.random() < per_channel_p:
        for c in range(image.shape[2]):
            m = (rng.random((gh, gw)) < drop_p).astype(np.uint8)
            mask = cvops.resize_nearest(m, (w, h))
            out[:, :, c] = np.where(mask > 0, 0, out[:, :, c])
    else:
        m = (rng.random((gh, gw)) < drop_p).astype(np.uint8)
        mask = cvops.resize_nearest(m, (w, h))
        out = np.where(mask[..., None] > 0, 0, out)
    return out


def salt_and_pepper(image, rng, p=0.05, per_channel=True):
    out = image.copy()
    noise = rng.random(image.shape if per_channel else image.shape[:2])
    out[noise < p / 2] = 0
    out[noise > 1 - p / 2] = 255
    return out


def multiply_hue_saturation(image, rng, lo=0.5, hi=1.5):
    hsv = cvops.bgr_to_hsv(image).astype(np.float32)
    hsv[:, :, 0] = (hsv[:, :, 0] * rng.uniform(lo, hi)) % 180
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] * rng.uniform(lo, hi), 0, 255)
    return cvops.hsv_to_bgr(hsv.astype(np.uint8))


def multiply_brightness(image, rng, lo=0.5, hi=1.5):
    return np.clip(image.astype(np.float32) * rng.uniform(lo, hi),
                   0, 255).astype(np.uint8)


def motion_blur(image, rng, k_range=(3, 9), angle_range=(-60, 60)):
    k = int(rng.integers(k_range[0], k_range[1] + 1))
    if k < 3:
        return image
    angle = rng.uniform(*angle_range)
    kernel = np.zeros((k, k), np.float32)
    kernel[k // 2, :] = 1.0
    M = cvops.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
    kernel = cvops.warp_affine(kernel, M, (k, k))
    s = kernel.sum()
    if s > 0:
        kernel /= s
    return cvops.filter2d(image, kernel)


class TemplateAug:
    def __call__(self, image, bbox, rng):
        if rng.random() < 0.4:
            image, bbox = fliplr(image, bbox)
        if rng.random() < 0.2:
            image, bbox = flipud(image, bbox)
        image, bbox = perspective(image, bbox, rng, scale=(0.01, 0.07))
        image = coarse_dropout(image, rng)
        image = salt_and_pepper(image, rng)
        return image, bbox


class SearchAug:
    def __call__(self, image, bbox, rng):
        image = multiply_hue_saturation(image, rng)
        image = multiply_brightness(image, rng)
        image = motion_blur(image, rng)
        return image, bbox


class MemoryAug:
    def __call__(self, image, bbox, rng):
        if rng.random() < 0.4:
            image, bbox = fliplr(image, bbox)
        if rng.random() < 0.2:
            image, bbox = flipud(image, bbox)
        image, bbox = perspective(image, bbox, rng, scale=(0.01, 0.15))
        image = multiply_hue_saturation(image, rng)
        image = multiply_brightness(image, rng)
        image = motion_blur(image, rng)
        return image, bbox
