"""PWCLite optical-flow network (ARFlow) in PyTorch, NCHW (counterpart of
`usot_tpu/preprocessing/pwclite.py`).

A 6-level feature pyramid, the cost-volume correlation (`correlation.py`),
the dense or reduce flow estimator, the dilated context network and the
coarse-to-fine warp loop, in 2-frame and 3-frame (forward + backward)
modes. The submodules carry ARFlow's own key names
(`feature_pyramid_extractor.convs.{l}.{0,1}.0`,
`flow_estimators.{conv1..conv5, predict_flow | conv_last}.0`,
`context_networks.convs.{0..6}.0`, `conv_1x1.{i}.0`), so a published
ARFlow checkpoint loads with `load_state_dict(strict=True)` after
`models.convert.strip_prefix`, and flax variables through
`models.convert.pwclite_state_dict_from_flax`.

Unlike the rest of the port, these functions take and return NCHW
tensors (cuDNN's layout); flows carry (dx, dy) in their channels.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from usot_tpu_torch.models.usot import lecun_normal_
from usot_tpu_torch.preprocessing.correlation import correlation

FEATURE_CHANNELS = (3, 16, 32, 64, 96, 128, 192)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class ConvL(nn.Sequential):
    """Conv2d with bias, `pad = (k - 1) * d // 2`, then leaky ReLU 0.1
    unless `relu=False` (ARFlow's `conv`: its weight is key `0.`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, relu: bool = True):
        pad = ((kernel - 1) * dilation) // 2
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, dilation)]
        if relu:
            layers.append(nn.LeakyReLU(0.1))
        super().__init__(*layers)


class FeatureExtractor(nn.Module):
    def __init__(self, num_chs=FEATURE_CHANNELS):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(ConvL(ch_in, ch_out, stride=2),
                          ConvL(ch_out, ch_out))
            for ch_in, ch_out in zip(num_chs[:-1], num_chs[1:]))

    def forward(self, x) -> List[torch.Tensor]:
        """The pyramid, coarsest level first."""
        pyramid = []
        for conv in self.convs:
            x = conv(x)
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    def __init__(self, ch_in: int):
        super().__init__()
        self.conv1 = ConvL(ch_in, 128)
        self.conv2 = ConvL(ch_in + 128, 128)
        self.conv3 = ConvL(ch_in + 256, 96)
        self.conv4 = ConvL(ch_in + 352, 64)
        self.conv5 = ConvL(ch_in + 416, 32)
        self.feat_dim = ch_in + 448
        self.conv_last = ConvL(self.feat_dim, 2, relu=False)

    def forward(self, x):
        x1 = torch.cat([self.conv1(x), x], 1)
        x2 = torch.cat([self.conv2(x1), x1], 1)
        x3 = torch.cat([self.conv3(x2), x2], 1)
        x4 = torch.cat([self.conv4(x3), x3], 1)
        x5 = torch.cat([self.conv5(x4), x4], 1)
        return x5, self.conv_last(x5)


class FlowEstimatorReduce(nn.Module):
    def __init__(self, ch_in: int):
        super().__init__()
        self.conv1 = ConvL(ch_in, 128)
        self.conv2 = ConvL(128, 128)
        self.conv3 = ConvL(128 + 128, 96)
        self.conv4 = ConvL(128 + 96, 64)
        self.conv5 = ConvL(96 + 64, 32)
        self.feat_dim = 32
        self.predict_flow = ConvL(64 + 32, 2, relu=False)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(torch.cat([x1, x2], 1))
        x4 = self.conv4(torch.cat([x2, x3], 1))
        x5 = self.conv5(torch.cat([x3, x4], 1))
        return x5, self.predict_flow(torch.cat([x4, x5], 1))


class ContextNetwork(nn.Module):
    def __init__(self, ch_in: int):
        super().__init__()
        layers, ch = [], ch_in
        for out, dil in ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16),
                         (32, 1)):
            layers.append(ConvL(ch, out, dilation=dil))
            ch = out
        layers.append(ConvL(ch, 2, relu=False))
        self.convs = nn.Sequential(*layers)

    def forward(self, x):
        return self.convs(x)


# Bilinear helpers with align_corners=True semantics.

def resize_bilinear_align_corners(x, new_h: int, new_w: int):
    """(B, C, H, W) -> (B, C, new_h, new_w), align_corners=True."""
    return F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                         align_corners=True)


def flow_warp(x, flow):
    """Warp x (B, C, H, W) by flow (B, 2, H, W) [dx, dy]: bilinear, the
    source coordinate clamped to the image (border padding),
    align_corners=True. The four neighbours are gathered by index, as
    JAX does, in one gather (no normalised-grid round trip)."""
    b, c, h, w = x.shape
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    sx = (gx + flow[:, 0]).clamp(0.0, w - 1.0)
    sy = (gy + flow[:, 1]).clamp(0.0, h - 1.0)
    x0 = sx.floor()
    y0 = sy.floor()
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                      dim=1).view(b, 1, 4 * h * w)
    corners = x.reshape(b, c, h * w).gather(
        2, idx.expand(b, c, 4 * h * w)).view(b, c, 4, h, w)
    p00, p01, p10, p11 = corners.unbind(2)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def resize_flow(flow, new_h: int, new_w: int):
    """Resize a flow field and rescale its vectors: every (dx, dy) pair
    of the channels (2, or 4 in 3-frame mode) by (new_w / w, new_h / h)."""
    b, c, h, w = flow.shape
    pairs = resize_bilinear_align_corners(flow, new_h, new_w).view(
        b, c // 2, 2, new_h, new_w)
    # scalar factors (rounded to the flow's dtype, as JAX's array is): no
    # host-to-device copy, so a CUDA graph can capture the forward
    return torch.stack([pairs[:, :, 0] * (new_w / w),
                        pairs[:, :, 1] * (new_h / h)], 2).view(
        b, c, new_h, new_w)


class PWCLite(nn.Module):
    """n_frames 2 or 3; `upsample` resizes each output flow 4x (the
    finest, at input/4, to the input's size)."""

    def __init__(self, n_frames: int = 3, reduce_dense: bool = True,
                 upsample: bool = True, search_range: int = 4,
                 output_level: int = 4):
        super().__init__()
        if n_frames not in (2, 3):
            raise NotImplementedError(f"n_frames={n_frames}")
        self.n_frames = n_frames
        self.upsample = upsample
        self.search_range = search_range
        self.output_level = output_level
        dim_corr = (2 * search_range + 1) ** 2
        self.feature_pyramid_extractor = FeatureExtractor()
        ch_in = 32 + (dim_corr + 2) * (n_frames - 1)
        estimator = FlowEstimatorReduce if reduce_dense \
            else FlowEstimatorDense
        self.flow_estimators = estimator(ch_in)
        self.context_networks = ContextNetwork(
            (self.flow_estimators.feat_dim + 2) * (n_frames - 1))
        self.conv_1x1 = nn.ModuleList(
            ConvL(ch, 32, kernel=1) for ch in FEATURE_CHANNELS[:1:-1])

    def _corr(self, a, b):
        return leaky(correlation(a, b, self.search_range))

    def _upsample(self, flows):
        if self.upsample:
            flows = [resize_flow(f, f.shape[2] * 4, f.shape[3] * 4)
                     for f in flows]
        return flows[::-1]

    def forward_2_frames(self, x1_pyr, x2_pyr):
        flows = []
        b, _, h, w = x1_pyr[0].shape
        flow = x1_pyr[0].new_zeros((b, 2, h, w))
        for level, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            if level == 0:
                x2_warp = x2
            else:
                flow = resize_flow(flow, x1.shape[2], x1.shape[3])
                x2_warp = flow_warp(x2, flow)
            out_corr = self._corr(x1, x2_warp)
            x1_1by1 = self.conv_1x1[level](x1)
            x_intm, flow_res = self.flow_estimators(
                torch.cat([out_corr, x1_1by1, flow], 1))
            flow = flow + flow_res
            flow = flow + self.context_networks(torch.cat([x_intm, flow], 1))
            flows.append(flow)
            if level == self.output_level:
                break
        return self._upsample(flows)

    def forward_3_frames(self, x0_pyr, x1_pyr, x2_pyr):
        flows = []
        b, _, h, w = x1_pyr[0].shape
        flow = x1_pyr[0].new_zeros((b, 4, h, w))
        for level, (x0, x1, x2) in enumerate(zip(x0_pyr, x1_pyr, x2_pyr)):
            if level == 0:
                x0_warp, x2_warp = x0, x2
            else:
                flow = resize_flow(flow, x1.shape[2], x1.shape[3])
                x0_warp = flow_warp(x0, flow[:, :2])
                x2_warp = flow_warp(x2, flow[:, 2:])
            corr_10 = self._corr(x1, x0_warp)
            corr_12 = self._corr(x1, x2_warp)
            x1_1by1 = self.conv_1x1[level](x1)
            fw, bw = flow[:, :2], flow[:, 2:]
            x_intm_10, fr_10 = self.flow_estimators(
                torch.cat([x1_1by1, corr_10, corr_12, fw, -bw], 1))
            x_intm_12, fr_12 = self.flow_estimators(
                torch.cat([x1_1by1, corr_12, corr_10, bw, -fw], 1))
            flow = flow + torch.cat([fr_10, fr_12], 1)
            fw, bw = flow[:, :2], flow[:, 2:]
            fr_10 = self.context_networks(
                torch.cat([x_intm_10, x_intm_12, fw, -bw], 1))
            fr_12 = self.context_networks(
                torch.cat([x_intm_12, x_intm_10, bw, -fw], 1))
            flow = flow + torch.cat([fr_10, fr_12], 1)
            flows.append(flow)
            if level == self.output_level:
                break
        flows = self._upsample(flows)
        return [f[:, :2] for f in flows], [f[:, 2:] for f in flows]

    def forward(self, x, with_bk: bool = False) -> Dict[str, list]:
        """x: (B, 3 * n_frames, H, W) stacked frames -> {"flows_fw": [...],
        "flows_bw": [...]}, each a list of (B, 2, h, w) flows, finest
        first (3-frame mode: forward = frame 1 -> 2, backward = 1 -> 0)."""
        n = x.shape[1] // 3
        if n != self.n_frames:
            raise ValueError(f"{x.shape[1]} channels for n_frames="
                             f"{self.n_frames}")
        imgs = [x[:, 3 * i:3 * i + 3] for i in range(n)]
        pyrs = [self.feature_pyramid_extractor(im) + [im] for im in imgs]
        out = {}
        if n == 2:
            out["flows_fw"] = self.forward_2_frames(pyrs[0], pyrs[1])
            if with_bk:
                out["flows_bw"] = self.forward_2_frames(pyrs[1], pyrs[0])
        else:
            flows_10, flows_12 = self.forward_3_frames(*pyrs)
            out["flows_fw"], out["flows_bw"] = flows_12, flows_10
        return out


@torch.no_grad()
def init_pwclite(model: PWCLite, generator: torch.Generator | None = None
                 ) -> PWCLite:
    """flax's init distributions (lecun-normal kernels, zero biases),
    drawn in module order from `generator` (a CPU torch.Generator; seed 0
    if None), so a seed gives the same weights on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            lecun_normal_(module.weight, generator)
            module.bias.zero_()
    return model
