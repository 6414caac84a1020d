"""Building blocks shared by the backbone, neck and head.

Every block takes its BatchNorm mode as an argument (`bn_train`), as the
flax modules do, instead of reading `nn.Module.training`: the staged
training schedule and the BN calibration switch the stem, the stages and
the head separately. Activations inside the model are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with flax's semantics (momentum 0.9, eps 1e-5).

    Eval mode normalises with the running stats. Train mode normalises
    with the batch stats and updates the running stats as flax does:
    `0.9 * old + 0.1 * batch` with the BIASED batch variance, computed as
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance). torch's own
    BatchNorm2d would store the unbiased variance.

    `num_batches_tracked` stays registered (torch's default) and is never
    read; a state dict without it (as `invert_usot_checkpoint` writes)
    still loads with strict=True, because BatchNorm2d fills a missing
    entry in."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x if x.dtype == torch.float64 else x.float()  # >= f32 stats
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(),
                          min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm as submodules "0" and "1", the reference's
    `nn.Sequential(conv, bn[, relu])` key layout (ReLU, if any, is applied
    by the caller or by `relu=True`)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation=1, bias: bool = False,
                 relu: bool = False):
        super().__init__()
        self.add_module("0", nn.Conv2d(cin, cout, kernel, stride=stride,
                                       padding=padding, dilation=dilation,
                                       bias=bias))
        self.add_module("1", BatchNorm(cout))
        self.relu = relu

    def forward(self, x, bn_train: bool = False):
        x = getattr(self, "1")(getattr(self, "0")(x), bn_train)
        return F.relu(x) if self.relu else x


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)
