"""Depthwise cross-correlation between per-sample kernels and search maps.

Counterpart of `usot_tpu/ops/xcorr.py:47-143`. NHWC throughout:

    out[b, i, j, c] = sum_{u,v} x[b, i+u, j+v, c] * k[b, u, v, c]   (VALID)

* `xcorr_depthwise` — the reference's grouped-conv trick
  (ref: lib/models/connect.py:147-157), pairwise; it mirrors JAX's XLA
  route and is what the unfused model runs.
* `xcorr_groupdw` (K1) — the fused 3-scale GroupDW sum, one search map
  against M kernels per scale;
* `xcorr_depthwise_multi` (K2) — one scale, one search map against M
  kernels;
* `xcorr_depthwise_pairwise` (K3) — one scale, pairwise.

Each of the last three dispatches on the device its tensors lie on: a
CPU tensor goes to the plain version beside it (`*_reference`, a
broadcast shift-multiply with f32 accumulation, output in the input
dtype), a CUDA tensor to the hand-written kernel (`xcorr_kernel.py`),
which raises on what it does not take. There is no fallback.

`CALL_LISTENERS` hear every call of the three, on any device, with the
call's analytic operation count (two per multiply-add), its inputs and
its output's bytes: the step tools (`tools/stage_cost.py`) count a call
so, since `FlopCounterMode` and a dispatch mode see aten ops and not the
kernels (nor, usefully, the plain versions' shift loops).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from usot_tpu_torch.ops.xcorr_kernel import (groupdw_out_hw,
                                             xcorr_depthwise_multi_cuda,
                                             xcorr_depthwise_pairwise_cuda,
                                             xcorr_groupdw_cuda)

# Context-manager factories, entered around every call of
# `xcorr_groupdw` ("K1"), `xcorr_depthwise_multi` ("K2") and
# `xcorr_depthwise_pairwise` ("K3") as fn(tag, flops, inputs, out_bytes):
# the call's analytic operations (two per multiply-add), its input
# tensors and the bytes of its output
CALL_LISTENERS: list = []


def _dispatch(tag, route, args, out_shape, taps):
    """route(*args), inside every listener's context; `out_shape` is a
    function of no arguments, called only when there are listeners."""
    if not CALL_LISTENERS:
        return route(*args)
    inputs = [t for a in args for t in (a if isinstance(a, list) else [a])]
    n = math.prod(out_shape())
    with contextlib.ExitStack() as stack:
        for fn in CALL_LISTENERS:
            stack.enter_context(fn(tag, 2.0 * taps * n, inputs,
                                   n * inputs[0].element_size()))
        return route(*args)


def xcorr_depthwise(x, kernel):
    """x: (B, Hx, Wx, C); kernel: (B, Hk, Wk, C) -> (B, Ho, Wo, C)."""
    b, hx, wx, c = x.shape
    _, hk, wk, _ = kernel.shape
    x_f = x.permute(0, 3, 1, 2).reshape(1, b * c, hx, wx)
    k_f = kernel.permute(0, 3, 1, 2).reshape(b * c, 1, hk, wk)
    out = F.conv2d(x_f, k_f.to(x_f.dtype), groups=b * c)
    ho, wo = out.shape[2], out.shape[3]
    return out.reshape(b, c, ho, wo).permute(0, 2, 3, 1)


def _shift_multiply_add(acc, x, k):
    """acc (B, M, Ho, Wo, C) f32 += multi-xcorr(x (B, Hx, Wx, C),
    k (B, M, Hk, Wk, C)), one broadcast multiply-add per tap."""
    ho, wo = acc.shape[2], acc.shape[3]
    x32, k32 = x.float(), k.float()
    for u in range(k.shape[2]):
        for v in range(k.shape[3]):
            acc += x32[:, None, u:u + ho, v:v + wo, :] \
                * k32[:, :, u, v, None, None, :]
    return acc


def _zeros_like_out(x, b, m, ho, wo, c):
    return torch.zeros((b, m, ho, wo, c), dtype=torch.float32,
                       device=x.device)


def xcorr_groupdw_reference(xs, ks):
    """Plain fused GroupDW: sum_s multi-xcorr(xs[s], ks[s]).

    xs: 3 search encodings (B, Hx_s, Wx_s, C); ks: 3 kernel stacks
    (B, M, Hk_s, Wk_s, C) with the softmax weights folded in.
    Returns (B, M, Ho, Wo, C) in the input dtype, accumulated in f32."""
    b, m, c = ks[0].shape[0], ks[0].shape[1], ks[0].shape[4]
    ho, wo = groupdw_out_hw(xs, ks)
    acc = _zeros_like_out(xs[0], b, m, ho, wo, c)
    for x, k in zip(xs, ks):
        _shift_multiply_add(acc, x, k)
    return acc.to(xs[0].dtype)


def xcorr_depthwise_multi_reference(x, kernel):
    """Plain K2: x (B, Hx, Wx, C), kernel (B, M, Hk, Wk, C) ->
    (B, M, Ho, Wo, C) in the input dtype, accumulated in f32."""
    b, hx, wx, c = x.shape
    m, hk, wk = kernel.shape[1], kernel.shape[2], kernel.shape[3]
    acc = _zeros_like_out(x, b, m, hx - hk + 1, wx - wk + 1, c)
    return _shift_multiply_add(acc, x, kernel).to(x.dtype)


def xcorr_depthwise_pairwise_reference(x, kernel):
    """Plain K3: x (B, Hx, Wx, C), kernel (B, Hk, Wk, C) ->
    (B, Ho, Wo, C): K2's plain version at M = 1."""
    return xcorr_depthwise_multi_reference(x, kernel[:, None])[:, 0]


def _single_out(x, kernel):
    """(B, Ho, Wo, C) of a single-scale VALID correlation."""
    return (x.shape[0], x.shape[1] - kernel.shape[-3] + 1,
            x.shape[2] - kernel.shape[-2] + 1, x.shape[3])


def xcorr_groupdw(xs, ks):
    """K1 on the device the tensors lie on (see the module note)."""
    route = xcorr_groupdw_reference if xs[0].device.type == "cpu" \
        else xcorr_groupdw_cuda
    return _dispatch(
        "K1", route, (list(xs), list(ks)),
        lambda: tuple(ks[0].shape[:2]) + groupdw_out_hw(xs, ks)
        + (ks[0].shape[4],), sum(k.shape[2] * k.shape[3] for k in ks))


def xcorr_depthwise_multi(x, kernel):
    """K2 on the device the tensors lie on (see the module note)."""
    route = xcorr_depthwise_multi_reference if x.device.type == "cpu" \
        else xcorr_depthwise_multi_cuda
    return _dispatch("K2", route, (x, kernel),
                     lambda: _single_out(x, kernel) + (kernel.shape[1],),
                     kernel.shape[2] * kernel.shape[3])


def xcorr_depthwise_pairwise(x, kernel):
    """K3 on the device the tensors lie on (see the module note)."""
    route = xcorr_depthwise_pairwise_reference if x.device.type == "cpu" \
        else xcorr_depthwise_pairwise_cuda
    return _dispatch("K3", route, (x, kernel),
                     lambda: _single_out(x, kernel),
                     kernel.shape[1] * kernel.shape[2])
