"""Correlation heads: multi-scale encoders, fused depthwise correlation,
confidence-value memory fusion and the cls/reg towers.

Counterpart of `usot_tpu/models/head.py:23-361` (ref:
lib/models/connect.py:12-281), with the engines' folded inference path
(`fold_inference_head`). The three "scales" are three differently
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

from usot_tpu_torch.models.layers import (BatchNorm, Conv2d, ConvBN,
                                         cast_param, derived, to_nchw,
                                         to_nhwc)
from usot_tpu_torch.ops.xcorr import xcorr_depthwise, xcorr_groupdw

# (reference name, (H, W) dilation) of the three scales
SCALES = (("matrix11", (1, 1)), ("matrix12", (2, 1)), ("matrix21", (1, 2)))


def _tenth(x):
    """0.1 * x with JAX's weak-typed scalar: the constant rounded to x's
    dtype first (0.10009765625 in bfloat16), as `0.1 * x` is in flax."""
    return x * float(torch.tensor(0.1, dtype=x.dtype))


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

    def scales(self, dtype):
        """The softmax of the scale weights in float32, cast to the
        compute dtype, in which they multiply the kernels (or the
        correlations), as flax does; computed once per checkpoint outside
        autograd (`derived`)."""
        return derived(self, "weight", ("softmax", dtype),
                       lambda w: torch.softmax(w, dim=0).to(dtype))

    def forward(self, zs, xs):
        """zs: 3 x (B, hk, wk, C); xs: 3 x (B, hx, wx, C) -> (B, Ho, Wo, C)."""
        w = self.scales(zs[0].dtype)
        if self.fused:
            # one kernel launch: weights folded into the kernels
            # (w * xcorr(x, k) == xcorr(x, w * k)); the kernel takes
            # contiguous NHWC, and conv outputs may be NCHW underneath
            ks = [(z[:, None] * w[i]).contiguous() for i, z in enumerate(zs)]
            return xcorr_groupdw([x.contiguous() for x in xs], ks)[:, 0]
        res = 0.0
        for i in range(3):
            res = res + w[i] * xcorr_depthwise(xs[i], zs[i])
        return res

    def multi(self, zs, xs, mem_size: int):
        """Memory-queue variant: UNREPEATED search encodings vs M kernels.

        zs: 3 x (B*M, hk, wk, C); xs: 3 x (B, hx, wx, C).
        Returns (B, M, Ho, Wo, C)."""
        w = self.scales(zs[0].dtype)
        ks = []
        for i, z in enumerate(zs):
            k = z.reshape((xs[i].shape[0], mem_size) + tuple(z.shape[1:]))
            ks.append((k * w[i]).contiguous())
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
            self.add_module(str(3 * i), Conv2d(channels, channels, 3,
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
        self.bbox_pred = Conv2d(channels, 4, 3, padding=1)
        self.cls_pred = Conv2d(channels, 1, 3, padding=1)
        self.cls_memory_pred = Conv2d(channels, 1, 3, padding=1)
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
        adjust = cast_param(self, "adjust", x_reg.dtype)
        bias = cast_param(self, "bias", x_reg.dtype)
        x_bbox = torch.exp(adjust * self.bbox_pred(x_reg) + bias)

        c = self.cls_tower(to_nchw(cls_dw), bn_train)
        cls = _tenth(self.cls_pred(c))
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
        cls_mem_dw = self.memory_correlation(cls_x, cls_mem_zs, mem_size)
        fused = self.conf_fusion(cls_mem_dw, bn_train)  # (B, Ho, Wo, C)
        c_mem = self.cls_memory_tower(to_nchw(fused), bn_train)
        return to_nhwc(_tenth(self.cls_memory_pred(c_mem)))

    def memory_correlation(self, cls_x, cls_mem_zs, mem_size: int):
        """GroupDW of the search encodings against the M queue kernels
        (3 x (B*M, h_i, w_i, C)). Returns (B, M, Ho, Wo, C)."""
        if self.fused_xcorr:
            # one launch, cls_x never repeated to B*M
            return self.cls_dw.multi(cls_mem_zs, cls_x, mem_size)
        batch = cls_x[0].shape[0]
        store_repeat = [torch.repeat_interleave(x, mem_size, dim=0)
                        for x in cls_x]
        dw = self.cls_dw(cls_mem_zs, store_repeat)  # (B*M, Ho, Wo, C)
        return dw.reshape((batch, mem_size) + tuple(dw.shape[1:]))

    # -- folded-weight inference path (see fold_inference_head) --

    def offline_fused_enc(self, xf, zf_enc, fused):
        """Offline branch on FOLDED search-encoder weights and
        pre-encoded template kernels. Same math as offline_preenc up to
        the f32 rounding of the fold. Returns (bbox, cls, cls_x)."""
        cls_x, reg_x = _apply_fused_encoders(xf, fused)
        cls_z, reg_z = zf_enc
        bbox, cls, _, _ = self.offline_preenc(xf, list(cls_z), list(reg_z),
                                              cls_x=cls_x, reg_x=reg_x)
        return bbox, cls, cls_x

    def memory_cls_fused(self, cls_x, cls_mem_zs, mem_size: int, fused):
        """Memory branch with ConfFusion's two convs FOLDED into one
        2C-wide conv ([conf || value]); the arithmetic after it (relu,
        clamp [-6, 4], exp, normalise over the queue, weighted sum) is
        ConfFusion's."""
        dw = self.memory_correlation(cls_x, cls_mem_zs, mem_size)
        b, m, h, w, c = dw.shape
        flat = to_nchw(dw.reshape(b * m, h, w, c))
        w_cv, b_cv = fused["conf_value"]
        y = F.relu(F.conv2d(flat, w_cv.to(flat.dtype), padding=1)
                   + b_cv.to(flat.dtype)[None, :, None, None])
        conf = torch.exp(torch.clamp(y[:, :c], -6.0, 4.0))
        conf = conf.reshape(b, m, c, h, w)
        conf = conf / torch.sum(conf, dim=1, keepdim=True)
        value = y[:, c:].reshape(b, m, c, h, w)
        c_mem = self.cls_memory_tower(torch.sum(conf * value, dim=1))
        return to_nhwc(_tenth(self.cls_memory_pred(c_mem)))


# -- folded inference-head weights (counterpart of
# usot_tpu/models/head.py:299-361): BatchNorm folded into the convs, the
# six search-side encoder blocks fused into three 2C-wide convs
# ([cls || reg] per dilation) and ConfFusion's two into one
# ([conf || value]). The wide convs are plain F.conv2d, as JAX leaves
# them to XLA. --

def _fold_conv_bn(block: ConvBN, eps: float = 1e-5):
    """W' = W * gamma / sqrt(var + eps), b' = beta - mean * gamma /
    sqrt(var + eps) (+ the conv bias, scaled). f32, as the JAX fold."""
    conv, bn = getattr(block, "0"), getattr(block, "1")
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    b = bn.bias.float() - bn.running_mean.float() * s
    if conv.bias is not None:
        b = b + conv.bias.float() * s
    return conv.weight.float() * s[:, None, None, None], b


@torch.no_grad()
def fold_inference_head(head: "BoxTowerReg"):
    """Folded inference-head weights from `head`'s own parameters and BN
    running stats, on its device:

        {"encoders": [(W (2C, C, 3, 3), b (2C,)) per dilation],
         "conf_value": (W (2C, C, 3, 3), b (2C,))}

    each W the output-channel concatenation [cls || reg] or
    [conf || value] of two ConvBN blocks, OIHW. Engines fold once per
    checkpoint; a frame step then runs 3 encoder convs instead of 6 and
    one ConfFusion conv instead of 2, with no BN ops."""
    encoders = []
    for name, _ in SCALES:
        wc, bc = _fold_conv_bn(getattr(head.cls_encode, f"{name}_s"))
        wr, br = _fold_conv_bn(getattr(head.reg_encode, f"{name}_s"))
        encoders.append((torch.cat([wc, wr]), torch.cat([bc, br])))
    wconf, bconf = _fold_conv_bn(head.conf_fusion.conf_gen)
    wval, bval = _fold_conv_bn(head.conf_fusion.value_gen)
    return {"encoders": encoders,
            "conf_value": (torch.cat([wconf, wval]),
                           torch.cat([bconf, bval]))}


def _apply_fused_encoders(xf, fused):
    """xf (B, H, W, C) -> (cls_x, reg_x) lists of 3 NHWC encodings via
    the three folded 2C-wide convs."""
    x = to_nchw(xf)
    cls_x, reg_x = [], []
    for (w, b), (_, dil) in zip(fused["encoders"], SCALES):
        y = F.relu(F.conv2d(x, w.to(x.dtype), dilation=dil)
                   + b.to(x.dtype)[None, :, None, None])
        half = y.shape[1] // 2
        cls_x.append(to_nhwc(y[:, :half]))
        reg_x.append(to_nhwc(y[:, half:]))
    return cls_x, reg_x

