"""Depthwise cross-correlation between per-sample kernels and search maps.

Counterpart of `usot_tpu/ops/xcorr.py:47-143`. NHWC throughout:

    out[b, i, j, c] = sum_{u,v} x[b, i+u, j+v, c] * k[b, u, v, c]   (VALID)

* `xcorr_depthwise` — the reference's grouped-conv trick
  (ref: lib/models/connect.py:147-157), pairwise.
* `xcorr_groupdw_reference` — the fused 3-scale GroupDW sum, one search
  map against M kernels, as a broadcast shift-multiply with f32
  accumulation (the plain version of the CUDA kernel).
* `xcorr_groupdw` — dispatch: a CPU tensor goes to the plain version, a
  CUDA tensor to the hand-written kernel (`xcorr_kernel.py`) or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from usot_tpu_torch.ops.xcorr_kernel import groupdw_out_hw, xcorr_groupdw_cuda


def xcorr_depthwise(x, kernel):
    """x: (B, Hx, Wx, C); kernel: (B, Hk, Wk, C) -> (B, Ho, Wo, C)."""
    b, hx, wx, c = x.shape
    _, hk, wk, _ = kernel.shape
    x_f = x.permute(0, 3, 1, 2).reshape(1, b * c, hx, wx)
    k_f = kernel.permute(0, 3, 1, 2).reshape(b * c, 1, hk, wk)
    out = F.conv2d(x_f, k_f.to(x_f.dtype), groups=b * c)
    ho, wo = out.shape[2], out.shape[3]
    return out.reshape(b, c, ho, wo).permute(0, 2, 3, 1)


def xcorr_groupdw_reference(xs, ks):
    """Plain PyTorch fused GroupDW: sum_s multi-xcorr(xs[s], ks[s]).

    xs: 3 search encodings (B, Hx_s, Wx_s, C); ks: 3 kernel stacks
    (B, M, Hk_s, Wk_s, C) with the softmax weights folded in.
    Returns (B, M, Ho, Wo, C) in the input dtype, accumulated in f32."""
    b, m, c = ks[0].shape[0], ks[0].shape[1], ks[0].shape[4]
    ho, wo = groupdw_out_hw(xs, ks)
    acc = torch.zeros((b, m, ho, wo, c), dtype=torch.float32,
                      device=xs[0].device)
    for x, k in zip(xs, ks):
        x32, k32 = x.float(), k.float()
        for u in range(k.shape[2]):
            for v in range(k.shape[3]):
                acc += x32[:, None, u:u + ho, v:v + wo, :] \
                    * k32[:, :, u, v, None, None, :]
    return acc.to(xs[0].dtype)


def xcorr_groupdw(xs, ks):
    """Fused GroupDW on the device the tensors lie on: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors (which raises on
    what it does not take; there is no fallback)."""
    if xs[0].device.type == "cpu":
        return xcorr_groupdw_reference(xs, ks)
    return xcorr_groupdw_cuda(xs, ks)
