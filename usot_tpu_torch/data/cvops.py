"""The OpenCV calls of the training data pipeline, without OpenCV.

Counterparts of the cv2 5.0 calls that `usot_tpu/data/augment.py`,
`usot_tpu/data/dataset.py` and the pseudo-label factory
(`usot_tpu/preprocessing/{inference,crop_gen}.py`) make, on uint8
(H, W, 3) BGR arrays (and the float32 motion-blur kernel; the flow
network's float32 frames as tensors). The pixel work runs in torch's
CPU ops (C++; gathers in numpy are far slower than cv2). Each op
releases the GIL, but a sample is many small ops with Python between
them, and on the H100's 8-core host the loader's threads did not scale:
6.7-10.6 cycle-memory samples/s at 1 thread, 8.5-10.8 at 8 (`PERF.md`;
ROADMAP's first training `perf_opt` item). Each function gives
cv2's answer within one grey level on every pixel
(`tests/test_torch_port_augment.py`):

- `warp_affine` / `warp_perspective`: bilinear with float weights,
  rounded to nearest, as cv2 5.0 computes INTER_LINEAR (not the 1/32-px
  fixed-point scheme of older releases); the affine's border is a
  constant (0 unless given), the perspective's the edge pixel
  (BORDER_REPLICATE);
- `resize_nearest`: INTER_NEAREST, source index floor(x / scale);
- `resize_linear`: INTER_LINEAR on float32 (N, C, H, W) tensors (the
  flow network's frames, on the card), torch's half-pixel bilinear
  without antialiasing, within 1e-4 of 255 of cv2;
- `bgr_to_hsv` / `hsv_to_bgr`: COLOR_BGR2HSV / COLOR_HSV2BGR on uint8,
  H in [0, 180): cv2's fixed-point division tables one way, its float
  sector formula the other, truncated to uint8 where cv2's vectorised
  loop runs and rounded in the scalar tail of each row;
- `filter2d`: a float kernel correlated with BORDER_REFLECT_101, the
  anchor at the kernel's centre, rounded and saturated to uint8;
- `perspective_transform`: getPerspectiveTransform's 4-point solve;
- `rotation_matrix_2d`: getRotationMatrix2D.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _to_uint8(t: torch.Tensor) -> torch.Tensor:
    """Round half to even and saturate (cv2's `saturate_cast<uchar>`)."""
    return torch.round(t).clamp_(0, 255).to(torch.uint8)


def _hwc(image: np.ndarray):
    """(H, W) or (H, W, C) -> (C, H, W) tensor view and a function back
    to the input's layout."""
    t = torch.from_numpy(np.ascontiguousarray(image))
    if t.ndim == 2:
        return t[None], lambda o: o[0]
    return t.permute(2, 0, 1), lambda o: o.permute(1, 2, 0)


def _remap(image: np.ndarray, map_x: torch.Tensor, map_y: torch.Tensor,
           border: str, border_value=0.0) -> np.ndarray:
    """Bilinear sample of `image` at the float64 source coordinates
    (map_x, map_y), each (Ho, Wo). border "constant": neighbours outside
    the image take `border_value` (a number, or one per channel);
    "replicate": they take the nearest edge pixel. uint8 images are
    rounded to uint8, float32 ones are returned as float32."""
    h, w = image.shape[:2]
    # only the source rows and columns the map reaches are converted
    x0 = max(0, min(w - 1, math.floor(float(map_x.min()))))
    x1 = max(0, min(w - 1, math.floor(float(map_x.max())) + 1))
    y0 = max(0, min(h - 1, math.floor(float(map_y.min()))))
    y1 = max(0, min(h - 1, math.floor(float(map_y.max())) + 1))
    if x1 == x0:  # a span of one pixel: take a neighbour in
        x0, x1 = max(0, x1 - 1), min(w - 1, x0 + 1)
    if y1 == y0:
        y0, y1 = max(0, y1 - 1), min(h - 1, y0 + 1)
    if x1 == x0 or y1 == y0:
        raise ValueError(f"image {image.shape}: needs 2 pixels a side")
    chw, back = _hwc(image)
    src = chw[:, y0:y1 + 1, x0:x1 + 1].float()[None]
    # a constant c outside: sample (image - c) with zeros outside, add c
    # back (the bilinear weights sum to 1)
    value = torch.from_numpy(np.broadcast_to(
        np.asarray(border_value, np.float32), (chw.shape[0],)).copy())
    value = value[:, None, None]
    src = src - value
    # grid_sample's align_corners=True grid: -1 and 1 are the centres of
    # the first and last source pixel
    gx = (map_x - x0) * (2.0 / (x1 - x0)) - 1.0
    gy = (map_y - y0) * (2.0 / (y1 - y0)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None].float()
    padding = "zeros" if border == "constant" else "border"
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode=padding,
                        align_corners=True)[0] + value
    if image.dtype == np.uint8:
        out = _to_uint8(out)
    return back(out).contiguous().numpy()


def _pixel_grid(size):
    w, h = size
    xs = torch.arange(w, dtype=torch.float64)[None, :]
    ys = torch.arange(h, dtype=torch.float64)[:, None]
    return xs, ys


def warp_affine(image: np.ndarray, matrix, size,
                border_value=0.0) -> np.ndarray:
    """`cv2.warpAffine(image, matrix, size, borderValue=border_value)`
    with INTER_LINEAR and BORDER_CONSTANT: output pixel (x, y) samples the
    source at inverse(matrix) @ (x, y, 1). `matrix` (2, 3) maps source to
    output; `size` is (width, height); uint8 (H, W[, C]) or float32
    (H, W). `border_value` is a number or one per channel (float64, e.g.
    a per-channel mean); cv2 converts it to the image's type first,
    rounding to nearest even and saturating for uint8."""
    m = np.asarray(matrix, np.float64)
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    xs, ys = _pixel_grid(size)
    map_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    map_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    value = np.asarray(border_value, np.float64)
    if image.dtype == np.uint8:
        value = np.clip(np.rint(value), 0, 255)
    return _remap(image, map_x, map_y, "constant", value)


def resize_linear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`cv2.resize(image, (width, height))` (INTER_LINEAR) of float32
    images, as a float (N, C, H, W) tensor on any device (the flow
    network resizes its frames on the card): source (x + 0.5) * sw / dw
    - 0.5, clamped to the image, float weights, no antialiasing when
    shrinking."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=False)


def warp_perspective(image: np.ndarray, matrix, size) -> np.ndarray:
    """`cv2.warpPerspective(image, matrix, size,
    borderMode=cv2.BORDER_REPLICATE)` with INTER_LINEAR."""
    inv = np.linalg.inv(np.asarray(matrix, np.float64))
    xs, ys = _pixel_grid(size)
    den = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    map_x = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) / den
    map_y = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) / den
    return _remap(image, map_x, map_y, "replicate")


def resize_nearest(image: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(image, size, interpolation=cv2.INTER_NEAREST)`:
    output (x, y) takes source (floor(x * sw / dw), floor(y * sh / dh)),
    with cv2's inverse scale `1 / (dw / sw)` in float64."""
    dw, dh = size
    sh, sw = image.shape[:2]
    cols = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))), sw - 1)
    rows = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))), sh - 1)
    return np.ascontiguousarray(
        image[rows.astype(np.int64)[:, None], cols.astype(np.int64)[None]])


# cv2's 8-bit HSV tables (`color_hsv.simd.hpp`): divisions as 12-bit
# fixed-point multiplies
_HSV_SHIFT = 12
_SDIV = torch.tensor([0] + [round((255 << _HSV_SHIFT) / i)
                            for i in range(1, 256)], dtype=torch.int32)
_HDIV = torch.tensor([0] + [round((180 << _HSV_SHIFT) / (6.0 * i))
                            for i in range(1, 256)], dtype=torch.int32)


def bgr_to_hsv(image: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(image, cv2.COLOR_BGR2HSV)` on uint8 (H, W, 3): V the
    max, S = 255 (V - min) / V, H in [0, 180), both divisions by cv2's
    rounded fixed-point tables."""
    t = torch.from_numpy(np.ascontiguousarray(image)).to(torch.int32)
    b, g, r = t.unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * torch.take(_SDIV, v.long()) + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * torch.take(_HDIV, diff.long()) + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8).numpy()


# cv2's HSV2RGB sector table: which of (v, p, q, t) each of b, g, r takes
_SECTORS = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


# pixels per step of cv2's vectorised HSV2BGR loop (its AVX2 build);
# each row's last `width % _HSV_STEP` pixels take its scalar loop
_HSV_STEP = 32


def hsv_to_bgr(image: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(image, cv2.COLOR_HSV2BGR)` on uint8 (H, W, 3) with H
    in [0, 180): cv2's float32 sector formula on (h * 6/180, s/255,
    v/255), times 255 to uint8. cv2's vectorised loop truncates; its
    scalar loop, which takes the last `W % 32` pixels of each row,
    rounds."""
    t = torch.from_numpy(np.ascontiguousarray(image)).float()
    h, s, v = t.unbind(-1)
    s = s * np.float32(1 / 255.0)
    v = v * np.float32(1 / 255.0)
    h = torch.fmod(h * np.float32(6.0 / 180.0), 6.0)  # in [0, 6)
    sector = torch.floor(h)
    h = h - sector
    sector = sector.long()
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * h),
                       v * (1.0 - s * (1.0 - h))], -1)
    bgr = torch.gather(tab, -1, _SECTORS[sector])
    bgr = torch.where((s == 0)[..., None], v[..., None], bgr) * 255.0
    vec = bgr.shape[1] - bgr.shape[1] % _HSV_STEP
    out = torch.cat([torch.floor(bgr[:, :vec]), torch.round(bgr[:, vec:])],
                    dim=1)
    return out.clamp_(0, 255).to(torch.uint8).numpy()


def filter2d(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.filter2D(image, -1, kernel)` on uint8 (H, W, C): correlation
    with the float32 `kernel` (kh, kw), anchor (kw // 2, kh // 2),
    BORDER_REFLECT_101 (torch's "reflect"), summed in float32, rounded
    and saturated to uint8. The sum runs over the kernel's nonzero taps
    only, as shifted views of the padded image (a motion-blur kernel has
    about 2k of its k^2 taps)."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = image.shape[:2]
    chw, back = _hwc(image)
    x = F.pad(chw.float()[None], (ax, kw - 1 - ax, ay, kh - 1 - ay),
              mode="reflect")[0]
    out = torch.zeros((x.shape[0], h, w))
    for i, j in zip(*np.nonzero(kernel)):
        out.add_(x[:, i:i + h, j:j + w], alpha=float(kernel[i, j]))
    return back(_to_uint8(out)).contiguous().numpy()


def perspective_transform(src, dst) -> np.ndarray:
    """`cv2.getPerspectiveTransform(src, dst)`: the (3, 3) float64
    homography with H[2, 2] = 1 that maps the four points `src` onto
    `dst` ((4, 2) each, read as float32 as cv2 takes them)."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    a = np.zeros((8, 8))
    rhs = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        rhs[i], rhs[i + 4] = u, v
    return np.append(np.linalg.solve(a, rhs), 1.0).reshape(3, 3)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: (2, 3) float64,
    a rotation by `angle` degrees (counter-clockwise in image axes)
    about `center`, times `scale`."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])
