"""PWCLite, ARFlow's optical-flow network (Liu et al., "Learning by
Analogy: Reliable Supervision from Transformations for Unsupervised
Optical Flow Estimation", CVPR 2020; github.com/lliuz/ARFlow
`models/pwclite.py`), in its 3-frame mode, in plain PyTorch, float32,
written from ARFlow's equations.

Every function takes the weights as one dict, name -> tensor, in
ARFlow's key layout (`feature_pyramid_extractor.convs.{l}.{0,1}.0`,
`flow_estimators.{conv1..conv5,predict_flow}.0`,
`context_networks.convs.{0..6}.0`, `conv_1x1.{l}.0`, each `.weight` and
`.bias`), so one state dict feeds this and the program alike. NCHW;
flows carry (dx, dy) in their channels.

* A conv: `F.conv2d` with its bias, padding (k - 1) * dilation / 2, then
  a leaky ReLU of slope 0.1, but for each estimator's and the context
  network's last conv.
* Pyramid: six levels of (3x3 stride 2, 3x3) at 16, 32, 64, 96, 128 and
  192 channels, coarsest first; the flow is estimated from the coarsest
  level (1/64) down to level 4 (1/4) and upsampled 4x.
* Cost volume: for each of the 81 shifts (dy, dx) in [-4, 4]^2, row by
  row, the channel mean of x1 times x2 shifted (zero outside), each shift
  one explicit slice and product; then a leaky ReLU.
* Warp: `F.grid_sample`, bilinear, border padding, align_corners=True,
  at the pixel grid plus the flow, normalised as ARFlow's `norm_grid`.
* A level (3-frame mode, frames 0, 1, 2; flow channels 0:2 the flow
  1 -> 0, 2:4 the flow 1 -> 2): the previous level's flow upsampled 2x
  (align_corners=True) and doubled; x0 warped by the flow 1 -> 0, x2 by
  1 -> 2; cost volumes c10 = corr(x1, x0w), c12 = corr(x1, x2w); the
  reduce estimator (128, 128, 96, 64, 32, densely linked as ARFlow's
  `FlowEstimatorReduce`) on [conv_1x1(x1), c10, c12, f10, -f12] and on
  [conv_1x1(x1), c12, c10, f12, -f10]; the residuals added; the context
  network (dilations 1, 2, 4, 8, 16, 1, then 2 channels) on
  [feat10, feat12, f10, -f12] and [feat12, feat10, f12, -f10], added.

Departure from ARFlow: none in the arithmetic. The cost volume is the
channel mean ARFlow's CUDA op takes (`corr / C`), with its zero padding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PYRAMID = (3, 16, 32, 64, 96, 128, 192)
ESTIMATOR = (("conv1", 128), ("conv2", 128), ("conv3", 96), ("conv4", 64),
             ("conv5", 32))
CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
SEARCH = 4
OUTPUT_LEVEL = 4


def param_shapes() -> dict:
    """{name: shape} of PWCLite's weights (3-frame mode, the reduce
    estimator), ARFlow's key layout."""
    shapes = {}

    def conv(name, cin, cout, k=3):
        shapes[f"{name}.0.weight"] = (cout, cin, k, k)
        shapes[f"{name}.0.bias"] = (cout,)
    for lvl, (cin, cout) in enumerate(zip(PYRAMID[:-1], PYRAMID[1:])):
        conv(f"feature_pyramid_extractor.convs.{lvl}.0", cin, cout)
        conv(f"feature_pyramid_extractor.convs.{lvl}.1", cout, cout)
    est_in = 32 + ((2 * SEARCH + 1) ** 2 + 2) * 2
    ins = {"conv1": est_in, "conv2": 128, "conv3": 256, "conv4": 224,
           "conv5": 160}
    for name, cout in ESTIMATOR:
        conv(f"flow_estimators.{name}", ins[name], cout)
    conv("flow_estimators.predict_flow", 64 + 32, 2)
    cin = (32 + 2) * 2
    for i, (cout, _) in enumerate(CONTEXT):
        conv(f"context_networks.convs.{i}", cin, cout)
        cin = cout
    conv(f"context_networks.convs.{len(CONTEXT)}", cin, 2)
    for lvl, ch in enumerate(PYRAMID[:1:-1]):
        conv(f"conv_1x1.{lvl}", ch, 32, k=1)
    return shapes


def leaky(x):
    return F.leaky_relu(x, 0.1)


def conv(w: dict, name: str, x, stride=1, dilation=1, relu=True):
    weight = w[f"{name}.0.weight"]
    pad = (weight.shape[-1] - 1) * dilation // 2
    y = F.conv2d(x, weight, w[f"{name}.0.bias"], stride, pad, dilation)
    return leaky(y) if relu else y


def pyramid(w: dict, img) -> list:
    """The feature pyramid of an image, coarsest level first."""
    out, x = [], img
    for lvl in range(len(PYRAMID) - 1):
        x = conv(w, f"feature_pyramid_extractor.convs.{lvl}.0", x, stride=2)
        x = conv(w, f"feature_pyramid_extractor.convs.{lvl}.1", x)
        out.append(x)
    return out[::-1]


def correlation(x1, x2, d: int = SEARCH):
    """(B, C, H, W) x 2 -> (B, (2d+1)^2, H, W): out[:, k] = mean over
    channels of x1 * x2 shifted by the k-th (dy, dx), row-major, zero
    outside. One slice and one product per shift."""
    b, c, h, w = x1.shape
    x2p = F.pad(x2, (d, d, d, d))
    out = []
    for dy in range(2 * d + 1):
        for dx in range(2 * d + 1):
            out.append((x1 * x2p[:, :, dy:dy + h, dx:dx + w]).mean(1))
    return torch.stack(out, 1)


def warp(x, flow):
    """x (B, C, H, W) sampled at the pixel grid plus flow (B, 2, H, W)."""
    b, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                            torch.arange(w, dtype=x.dtype, device=x.device),
                            indexing="ij")
    sx = 2.0 * (gx + flow[:, 0]) / max(w - 1, 1) - 1.0
    sy = 2.0 * (gy + flow[:, 1]) / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack([sx, sy], -1), mode="bilinear",
                         padding_mode="border", align_corners=True)


def estimator(w: dict, x):
    """(features, flow residual) of the reduce estimator."""
    e = "flow_estimators."
    x1 = conv(w, e + "conv1", x)
    x2 = conv(w, e + "conv2", x1)
    x3 = conv(w, e + "conv3", torch.cat([x1, x2], 1))
    x4 = conv(w, e + "conv4", torch.cat([x2, x3], 1))
    x5 = conv(w, e + "conv5", torch.cat([x3, x4], 1))
    return x5, conv(w, e + "predict_flow", torch.cat([x4, x5], 1),
                    relu=False)


def context(w: dict, x):
    for i, (_, dil) in enumerate(CONTEXT):
        x = conv(w, f"context_networks.convs.{i}", x, dilation=dil)
    return conv(w, f"context_networks.convs.{len(CONTEXT)}", x, relu=False)


def up(flow, factor: int):
    """The flow upsampled `factor` times (bilinear, align_corners=True),
    its vectors times `factor`, as ARFlow's `F.interpolate(flow *
    factor, scale_factor=factor, ...)`."""
    return F.interpolate(flow * factor, scale_factor=factor, mode="bilinear",
                         align_corners=True)


def flows_3_frames(w: dict, x0, x1, x2):
    """The 3-frame forward of images (B, 3, H, W) in [0, 1]: (flow 1 -> 2,
    flow 1 -> 0), each (B, 2, H, W) at the input's size."""
    p0, p1, p2 = pyramid(w, x0), pyramid(w, x1), pyramid(w, x2)
    b, _, h, wd = p1[0].shape
    flow = p1[0].new_zeros((b, 4, h, wd))
    for lvl in range(OUTPUT_LEVEL + 1):
        f0, f1, f2 = p0[lvl], p1[lvl], p2[lvl]
        if lvl:
            flow = up(flow, 2)
            f0, f2 = warp(f0, flow[:, :2]), warp(f2, flow[:, 2:])
        c10, c12 = leaky(correlation(f1, f0)), leaky(correlation(f1, f2))
        x1by1 = conv(w, f"conv_1x1.{lvl}", f1)
        f10, f12 = flow[:, :2], flow[:, 2:]
        feat10, r10 = estimator(w, torch.cat([x1by1, c10, c12, f10, -f12], 1))
        feat12, r12 = estimator(w, torch.cat([x1by1, c12, c10, f12, -f10], 1))
        flow = flow + torch.cat([r10, r12], 1)
        f10, f12 = flow[:, :2], flow[:, 2:]
        flow = flow + torch.cat([
            context(w, torch.cat([feat10, feat12, f10, -f12], 1)),
            context(w, torch.cat([feat12, feat10, f12, -f10], 1))], 1)
    flow = up(flow, 4)
    return flow[:, 2:], flow[:, :2]
