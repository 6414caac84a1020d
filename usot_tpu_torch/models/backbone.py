"""Modified ResNet-50 backbone ("ResNet_plus2"), counterpart of
`usot_tpu/models/backbone.py` (ref: lib/models/modules.py:61-151).

  * 7x7 stride-2 stem conv with NO padding, then 3x3/2 maxpool pad 1
  * layer1: 3 bottlenecks, stride 1 (1x1 downsample)
  * layer2: 4 bottlenecks, the first with stride 2, a 3x3 pad-0 conv2 and
    a 3x3 pad-0 stride-2 downsample
  * layer3: 6 bottlenecks, dilation 2; the first runs its 3x3 at
    dilation 1 / pad 1 with a 3x3 pad-1 downsample
  * output is layer3 (stride 8, 16*width channels)

Spatial sizes: 255 -> 31, 127 -> 15, 271 -> 33. Submodule names follow
the reference state dict (`conv1`, `bn1`, `layer1.0.conv1`, ...,
`layer2.0.downsample.0`). The TPU layout rewrites `s2d_stem` and
`s2b_dilated` are not carried over.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from usot_tpu_torch.models.layers import (BatchNorm, Conv2d, ConvBN,
                                         compute_dtype, to_nchw, to_nhwc)

LAYERS = (3, 4, 6)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 conv2_padding: int = 1, conv2_dilation: int = 1,
                 downsample_kernel: int | None = None,
                 downsample_padding: int = 0):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=conv2_padding,
                            dilation=conv2_dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = None
        if downsample_kernel is not None:
            self.downsample = ConvBN(cin, planes * 4, downsample_kernel,
                                     stride=stride,
                                     padding=downsample_padding)

    def forward(self, x, bn_train: bool):
        out = F.relu(self.bn1(self.conv1(x), bn_train))
        out = F.relu(self.bn2(self.conv2(out), bn_train))
        out = self.bn3(self.conv3(out), bn_train)
        residual = x if self.downsample is None \
            else self.downsample(x, bn_train)
        return F.relu(out + residual)


def _stage(cin: int, planes: int, blocks: int, stride: int, dilation: int):
    if dilation > 1:
        # First block halves the dilation (ref modules.py:19-21) and the
        # downsample is 3x3 with padding = dilation // 2 (ref :114-126)
        first = Bottleneck(cin, planes, stride, dilation // 2,
                           dilation // 2, 3, dilation // 2)
        rest_pad, rest_dil = dilation, dilation
    elif stride != 1:
        first = Bottleneck(cin, planes, stride, 2 - stride, 1, 3, 0)
        rest_pad, rest_dil = 1, 1
    else:
        first = Bottleneck(cin, planes, 1, 1, 1, 1, 0)
        rest_pad, rest_dil = 1, 1
    rest = [Bottleneck(planes * 4, planes, 1, rest_pad, rest_dil)
            for _ in range(1, blocks)]
    return nn.ModuleList([first, *rest])


class ResNetPlus2(nn.Module):
    """(N, H, W, 3) NHWC -> layer3 feature (N, H/8, W/8, 16*width), in
    the compute dtype: the stem casts its input to it (flax's
    `StemConvBN`, `usot_tpu/models/backbone.py:57-59`), and every later
    block computes in the dtype of its input."""

    def __init__(self, width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        w = width
        self.dtype = dtype
        self.conv1 = Conv2d(3, w, 7, stride=2, padding=0, bias=False)
        self.bn1 = BatchNorm(w)
        self.layer1 = _stage(w, w, LAYERS[0], 1, 1)
        self.layer2 = _stage(4 * w, 2 * w, LAYERS[1], 2, 1)
        self.layer3 = _stage(8 * w, 4 * w, LAYERS[2], 1, 2)

    def forward(self, x, stem_bn_train: bool = False,
                stage_bn_train: bool = False, remat: bool = False,
                n_stages: int = 3):
        """BN modes: stem (conv1/bn1) and stages separately, mirroring the
        staged freeze/unfreeze schedule (ref: scripts/train_usot.py:72-102).
        remat: each bottleneck under `torch.utils.checkpoint`, so backward
        keeps only the blocks' inputs and recomputes one block at a time
        (its train-mode BNs update their running stats again; the
        training step puts them back). n_stages < 3 stops after the
        stem and pool (0) or after layer1 or layer2: the prefixes the
        step attribution times (`tools/microbench_step.py`)."""
        x = to_nchw(x).to(compute_dtype(self.dtype, self.conv1.weight))
        x = F.relu(self.bn1(self.conv1(x), stem_bn_train))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3)[:n_stages]:
            for block in layer:
                if remat:
                    x = torch.utils.checkpoint.checkpoint(
                        block, x, stage_bn_train, use_reentrant=False)
                else:
                    x = block(x, stage_bn_train)
        return to_nhwc(x)


class ResNet50(nn.Module):
    """The reference's wrapper level (`features.features.*` keys)."""

    def __init__(self, width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = ResNetPlus2(width, dtype)

    def forward(self, x, stem_bn_train: bool = False,
                stage_bn_train: bool = False, remat: bool = False):
        return self.features(x, stem_bn_train, stage_bn_train, remat)
