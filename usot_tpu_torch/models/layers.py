"""Building blocks shared by the backbone, neck and head.

Every block takes its BatchNorm mode as an argument (`bn_train`), as the
flax modules do, instead of reading `nn.Module.training`: the staged
training schedule and the BN calibration switch the stem, the stages and
the head separately. Activations inside the model are NCHW.

Mixed precision follows flax's `dtype` (`usot_tpu/models/usot.py:65`):
parameters and BN statistics stay float32, and every block computes in
the dtype of its input, which the backbone's stem sets (`compute_dtype`).
The rounding points are flax's: a convolution takes input and kernel in
the compute dtype and rounds its output once; its bias is added after,
in the compute dtype (flax's `promote_dtype` then `y += bias`); eval-mode
BatchNorm normalises in float32 from the rounded input and rounds once
(flax's `_normalize`). The reduced-precision copies of the parameters are
cast once and kept until the parameter changes (`cast_param`, over
`derived`), so a frame step launches no cast of the weights.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from usot_tpu_torch.parallel.mesh import all_reduce_sum


def compute_dtype(dtype: torch.dtype, like: torch.Tensor) -> torch.dtype:
    """The dtype a model computes in: `dtype` (given at `build_usot`)
    when it is a 16-bit type (bfloat16), whatever its parameters' width;
    otherwise the parameter `like`'s own (float32, or float64 for a model
    cast with `.to(torch.float64)`, the training tests' reference
    precision)."""
    return dtype if dtype.itemsize < 4 else like.dtype


def derived(module: nn.Module, name: str, tag, fn):
    """`fn(module.<name>)`, computed once and kept on the module until the
    parameter changes (an in-place update bumps its version counter, a
    move gives it new storage; the kept `detach()` shares the counter and
    holds the old storage, whose address a new one can therefore not
    reuse). Under autograd, for a parameter that takes gradients, it is
    computed anew every call. `tag` names the function."""
    p = getattr(module, name)
    if p.requires_grad and torch.is_grad_enabled():
        return fn(p)
    cache = module.__dict__.setdefault("_derived", {})
    hit = cache.get((name, tag))
    if hit is not None:
        src, version, value = hit
        if src.data_ptr() == p.data_ptr() and src._version == version:
            return value
    with torch.inference_mode(False):  # usable outside inference mode
        src = p.detach()
        value = fn(src)
    cache[(name, tag)] = (src, src._version, value)
    return value


def cast_param(module: nn.Module, name: str, dtype: torch.dtype):
    """`module.<name>` in `dtype`: the parameter itself when it already
    is, else a copy cast once (`derived`)."""
    p = getattr(module, name)
    if p.dtype == dtype:
        return p
    return derived(module, name, dtype, lambda t: t.to(dtype))


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the dtype of its input, with flax's rounding points:
    the kernel cast to the input's dtype, the output rounded once, the
    bias added after the convolution in that dtype. In the parameters'
    own dtype it is nn.Conv2d's forward.

    The cast kernel is kept in the input's memory format: cuDNN runs
    bf16 convolutions channels-last, and torch would otherwise convert
    an OIHW kernel to channels-last at every call."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dtype = x.dtype
        if not x.is_contiguous() \
                and x.is_contiguous(memory_format=torch.channels_last):
            w = derived(self, "weight", (dtype, "channels_last"),
                        lambda t: t.to(dtype).contiguous(
                            memory_format=torch.channels_last))
        else:
            w = cast_param(self, "weight", dtype)
        y = self._conv_forward(x, w, None)
        if self.bias is None:
            return y
        return y + cast_param(self, "bias", dtype)[:, None, None]


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
    entry in.

    Input in a narrower dtype than the stats (bfloat16): eval mode
    normalises in float32 and rounds once to the input's dtype, flax's
    `_normalize`, by one of two branches: `F.batch_norm` on the mixed
    dtypes on the CPU, `batch_norm_elemt` with the per-channel
    `rsqrt(var + eps)` kept (`derived`) on the card. Each is held against
    the written-out `(x - mean) * rsqrt(var + eps) * scale + bias`
    rounded once: the CPU's by `tests/test_torch_port_bf16.py`, the
    card's by `chip_smoke.bn_rounding_check` (phase 11, and
    `tests/test_torch_port_smoke.py`'s gpu test). `batch_norm_elemt` has
    no derivative, and no training phase needs one: the eval-mode BNs
    of the trainer's phases (the stem, and the stages while frozen) lie
    downstream of no trainable parameter. Train mode computes its
    float32 statistics and output the same way.

    `group`: a process group (set by the data-parallel training step,
    `train/step.set_bn_group`), or None. With one, train mode sums the
    per-channel sum(x), sum(x^2) and count over the group
    (`parallel.mesh.all_reduce_sum`, which carries the gradient) and
    takes mean and variance from the global sums: the statistics of the
    global batch, as BatchNorm under JAX's mesh computes them, and the
    same running stats on every rank."""

    group = None

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x, train: bool = False):
        if not train:
            if x.dtype == self.running_var.dtype or x.device.type != "cuda":
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0,
                                    self.eps)
            # mixed dtypes on the card: torch's native BN (cuDNN takes no
            # bf16) launches a kernel for rsqrt(var + eps) at every call;
            # keep that per channel and normalise in one launch
            invstd = derived(self, "running_var", ("invstd", self.eps),
                             lambda v: torch.rsqrt(v + self.eps))
            return torch.batch_norm_elemt(x, self.weight, self.bias,
                                          self.running_mean, invstd,
                                          self.eps)
        xf = x if x.dtype == torch.float64 else x.float()  # >= f32 stats
        if self.group is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = xf.square().mean(dim=(0, 2, 3))
        else:
            sums = torch.stack([
                xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                xf.new_full((xf.shape[1],), xf.numel() // xf.shape[1])])
            sums = all_reduce_sum(sums, self.group)
            mean, mean_sq = sums[0] / sums[2], sums[1] / sums[2]
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
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
        self.add_module("0", Conv2d(cin, cout, kernel, stride=stride,
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
