"""Correlation heads: multi-scale encoders, fused depthwise correlation,
confidence-value memory fusion and the cls/reg towers.

Counterpart of `usot_tpu/models/head.py:23-246` (ref:
lib/models/connect.py:12-281). The three "scales" are three differently
dilated 3x3 VALID convs on the same input; the kernel (z) and search (x)
sides have their own weights. The three depthwise correlations are
fused with a softmax-weighted learnable 3-vector. Public methods take and
return NHWC; submodule names follow the reference state dict
(`cls_encode.matrix11_k.0`, `bbox_tower.3`, ...).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from usot_tpu_torch.models.layers import BatchNorm, ConvBN, to_nchw, to_nhwc
from usot_tpu_torch.ops.xcorr import xcorr_depthwise, xcorr_groupdw

# (reference name, (H, W) dilation) of the three scales
SCALES = (("matrix11", (1, 1)), ("matrix12", (2, 1)), ("matrix21", (1, 2)))


class Matrix(nn.Module):
    """Both sides of one multi-scale encoder (ref `matrix`): per side,
    three dilated 3x3 VALID conv+BN+ReLU blocks on the same input."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        for name, dil in SCALES:
            for side in ("k", "s"):
                self.add_module(f"{name}_{side}",
                                ConvBN(cin, cout, 3, dilation=dil, relu=True))

    def encode(self, x, side: str, bn_train: bool = False) -> List:
        """x: (N, H, W, C) -> 3 NHWC encodings (one per scale)."""
        x = to_nchw(x)
        return [to_nhwc(getattr(self, f"{name}_{side}")(x, bn_train))
                for name, _ in SCALES]


class GroupDW(nn.Module):
    """Softmax-weighted fusion of the three depthwise correlations."""

    def __init__(self, fused: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(3))
        self.fused = fused

    def forward(self, zs, xs):
        """zs: 3 x (B, hk, wk, C); xs: 3 x (B, hx, wx, C) -> (B, Ho, Wo, C)."""
        w = torch.softmax(self.weight, dim=0)
        if self.fused:
            # one kernel launch: weights folded into the kernels
            # (w * xcorr(x, k) == xcorr(x, w * k)); the kernel takes
            # contiguous NHWC, and conv outputs may be NCHW underneath
            ks = [(z[:, None] * w[i].to(z.dtype)).contiguous()
                  for i, z in enumerate(zs)]
            return xcorr_groupdw([x.contiguous() for x in xs], ks)[:, 0]
        res = 0.0
        for i in range(3):
            res = res + w[i].to(xs[i].dtype) * xcorr_depthwise(xs[i], zs[i])
        return res

    def multi(self, zs, xs, mem_size: int):
        """Memory-queue variant: UNREPEATED search encodings vs M kernels.

        zs: 3 x (B*M, hk, wk, C); xs: 3 x (B, hx, wx, C).
        Returns (B, M, Ho, Wo, C)."""
        w = torch.softmax(self.weight, dim=0)
        ks = []
        for i, z in enumerate(zs):
            k = z.reshape((xs[i].shape[0], mem_size) + tuple(z.shape[1:]))
            ks.append((k * w[i].to(k.dtype)).contiguous())
        return xcorr_groupdw([x.contiguous() for x in xs], ks)


class ConfFusion(nn.Module):
    """Confidence-value fusion over the memory dimension
    (ref: lib/models/connect.py:104-144)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.conf_gen = ConvBN(channels, channels, 3, padding=1, bias=True,
                               relu=True)
        self.value_gen = ConvBN(channels, channels, 3, padding=1, bias=True,
                                relu=True)

    def forward(self, x, bn_train: bool = False):
        """x: (B, M, H, W, C) -> (B, H, W, C)."""
        b, m, h, w, c = x.shape
        flat = to_nchw(x.reshape(b * m, h, w, c))
        conf = torch.clamp(self.conf_gen(flat, bn_train), -6.0, 4.0)
        conf = torch.exp(conf).reshape(b, m, -1, h, w)
        conf = conf / torch.sum(conf, dim=1, keepdim=True)
        value = self.value_gen(flat, bn_train).reshape(b, m, -1, h, w)
        return to_nhwc(torch.sum(conf * value, dim=1))


class Tower(nn.Module):
    """Stack of conv3x3(pad 1, bias)+BN+ReLU blocks, NCHW in and out.
    Keys `3i` (conv) and `3i+1` (BN), as the reference's Sequential."""

    def __init__(self, channels: int = 256, num: int = 4):
        super().__init__()
        self.num = num
        for i in range(num):
            self.add_module(str(3 * i), nn.Conv2d(channels, channels, 3,
                                                  padding=1, bias=True))
            self.add_module(str(3 * i + 1), BatchNorm(channels))

    def forward(self, x, bn_train: bool = False):
        for i in range(self.num):
            x = getattr(self, str(3 * i))(x)
            x = F.relu(getattr(self, str(3 * i + 1))(x, bn_train))
        return x


class BoxTowerReg(nn.Module):
    """Offline cls/reg head + online memory cls head (ref `box_tower_reg`)."""

    def __init__(self, channels: int = 256, tower_num: int = 4,
                 fused_xcorr: bool = False):
        super().__init__()
        self.cls_encode = Matrix(channels, channels)
        self.reg_encode = Matrix(channels, channels)
        self.cls_dw = GroupDW(fused_xcorr)
        self.reg_dw = GroupDW(fused_xcorr)
        self.conf_fusion = ConfFusion(channels)
        self.bbox_tower = Tower(channels, tower_num)
        self.cls_tower = Tower(channels, tower_num)
        self.cls_memory_tower = Tower(channels, tower_num)
        self.bbox_pred = nn.Conv2d(channels, 4, 3, padding=1)
        self.cls_pred = nn.Conv2d(channels, 1, 3, padding=1)
        self.cls_memory_pred = nn.Conv2d(channels, 1, 3, padding=1)
        self.adjust = nn.Parameter(0.1 * torch.ones(1))
        self.bias = nn.Parameter(torch.ones(1, 4, 1, 1))
        self.fused_xcorr = fused_xcorr

    def encode_search(self, search, bn_train: bool = False):
        """Search-side encodings (cls_x, reg_x), each 3 NHWC tensors."""
        return (self.cls_encode.encode(search, "s", bn_train),
                self.reg_encode.encode(search, "s", bn_train))

    def encode_kernel(self, kernel, bn_train: bool = False):
        """Kernel-side encodings (cls_z, reg_z) of a pooled 7x7 feature."""
        return (self.cls_encode.encode(kernel, "k", bn_train),
                self.reg_encode.encode(kernel, "k", bn_train))

    def offline(self, search, kernel, bn_train: bool = False,
                cls_x=None, reg_x=None):
        """Offline Siamese branch: bbox (B,Ho,Wo,4), cls (B,Ho,Wo,1)."""
        cls_z, reg_z = self.encode_kernel(kernel, bn_train)
        return self.offline_preenc(search, cls_z, reg_z, bn_train,
                                   cls_x=cls_x, reg_x=reg_x)

    def offline_preenc(self, search, cls_z, reg_z, bn_train: bool = False,
                       cls_x=None, reg_x=None):
        """Offline branch with PRE-ENCODED kernel sides (see encode_kernel).
        Returns (bbox, cls, cls_x, reg_x)."""
        if cls_x is None:
            cls_x = self.cls_encode.encode(search, "s", bn_train)
        if reg_x is None:
            reg_x = self.reg_encode.encode(search, "s", bn_train)

        cls_dw = self.cls_dw(cls_z, cls_x)
        reg_dw = self.reg_dw(reg_z, reg_x)

        x_reg = self.bbox_tower(to_nchw(reg_dw), bn_train)
        x_bbox = torch.exp(self.adjust * self.bbox_pred(x_reg) + self.bias)

        c = self.cls_tower(to_nchw(cls_dw), bn_train)
        cls = 0.1 * self.cls_pred(c)
        return to_nhwc(x_bbox), to_nhwc(cls), cls_x, reg_x

    def memory_cls(self, cls_x, memory_kernel, mem_size: int,
                   bn_train: bool = False):
        """Online memory branch. cls_x: 3 cached search encodings
        (B, h_i, w_i, C); memory_kernel: (B*mem_size, 7, 7, C).
        Returns cls_mem (B, Ho, Wo, 1)."""
        cls_mem_zs = self.cls_encode.encode(memory_kernel, "k", bn_train)
        return self.memory_cls_preenc(cls_x, cls_mem_zs, mem_size, bn_train)

    def memory_cls_preenc(self, cls_x, cls_mem_zs, mem_size: int,
                          bn_train: bool = False):
        """Online memory branch with PRE-ENCODED queue kernels: cls_mem_zs
        is 3 x (B*mem_size, h_i, w_i, C)."""
        batch = cls_x[0].shape[0]
        if self.fused_xcorr:
            # one launch, cls_x never repeated to B*M
            cls_mem_dw = self.cls_dw.multi(cls_mem_zs, cls_x, mem_size)
        else:
            store_repeat = [torch.repeat_interleave(x, mem_size, dim=0)
                            for x in cls_x]
            dw = self.cls_dw(cls_mem_zs, store_repeat)  # (B*M, Ho, Wo, C)
            cls_mem_dw = dw.reshape((batch, mem_size) + tuple(dw.shape[1:]))

        fused = self.conf_fusion(cls_mem_dw, bn_train)  # (B, Ho, Wo, C)
        c_mem = self.cls_memory_tower(to_nchw(fused), bn_train)
        return to_nhwc(0.1 * self.cls_memory_pred(c_mem))
