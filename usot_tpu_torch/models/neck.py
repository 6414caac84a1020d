"""AdjustLayer neck: 1x1 channel reduction + BN, with the template cropped
either by a fixed centre crop or by PrRoIPooling the pseudo bbox.
Counterpart of `usot_tpu/models/neck.py` (ref: lib/models/connect.py:284-314).
"""
from __future__ import annotations

import torch.nn as nn

from usot_tpu_torch.models.layers import ConvBN, to_nchw, to_nhwc
from usot_tpu_torch.ops.prroi import prroi_pool_same_batch


class AdjustLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        self.downsample = ConvBN(in_channels, out_channels, 1)

    def forward(self, x, bn_train: bool = False, crop: bool = False,
                pr_pool: bool = True, bbox=None):
        """x: (N, H, W, Cin) NHWC. Returns x_ori, or (x_ori, cropped) with
        crop=True: a 7x7 PrRoIPool by `bbox` (N, 4) or the centre crop."""
        x_ori = to_nhwc(self.downsample(to_nchw(x), bn_train))
        if not crop:
            return x_ori
        if pr_pool:
            if bbox is None:
                raise ValueError("pr_pool crop needs a bbox")
            xf = prroi_pool_same_batch(x_ori, bbox, pooled=7)
        else:
            xf = x_ori[:, 4:-4, 4:-4, :]
        return x_ori, xf
