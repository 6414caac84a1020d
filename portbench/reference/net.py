"""The USOT* network in plain PyTorch, written from the published
description (Zheng et al., "Learning to Track Objects from Unlabeled
Videos", ICCV 2021, arXiv 2108.12711, and its released model layout).

Every function takes the weights as one dict, name -> tensor, in the
released checkpoint's key layout (`features.features.*`, `neck.*`,
`connect_model.*`), with the BatchNorm statistics under
`<bn>.running_mean` / `<bn>.running_var`. Activations are NCHW and
float32; nothing here keeps state between calls.

* Backbone: ResNet-50 up to layer3 ("ResNet_plus2"). The 7x7 stride-2
  stem has no padding, then a 3x3/2 max-pool (pad 1); layer1 3
  bottlenecks; layer2 4, the first with a 3x3 pad-0 stride-2 conv2 and
  a 3x3 pad-0 stride-2 downsample; layer3 6 at dilation 2, the first
  at dilation 1 / pad 1 with a 3x3 pad-1 downsample. 255 -> 31, 127 ->
  15 cells.
* Neck: 1x1 conv + BN to 256 channels; the template is PrRoI-pooled to
  7x7 by its box.
* Head: per branch (cls, reg) and side (template "k", search "s") three
  3x3 VALID conv+BN+ReLU encoders at dilations (1,1), (2,1), (1,2); the
  three depthwise correlations summed with softmax weights (GroupDW);
  towers of four 3x3 conv+BN+ReLU; bbox = exp(adjust * pred + bias),
  cls = 0.1 * pred. The memory branch correlates the search encodings
  with M memory kernels, fuses the M maps by confidence-value fusion
  (conf = exp(clamp(conv, -6, 4)) normalised over M, times value) and
  runs its own tower and predictor.

`Net(weights, mode, q)`: `mode` is "eval" (running statistics),
"train" (batch statistics; the updated running statistics go to
`net.new_stats`, flax's rule 0.9 * old + 0.1 * batch with the biased
variance) or "set" (batch statistics written as the running ones: the
one-pass calibration of random weights). `q` rounds every convolution's
and correlation's operands and result and every BN's output (the
lower-precision control: a network computed in that precision); None
keeps float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
ENCODERS = (("matrix11", (1, 1)), ("matrix12", (2, 1)), ("matrix21", (1, 2)))
BLOCKS = (3, 4, 6)
BACKBONE = "features.features."
HEAD = "connect_model."


# ----------------------------------------------------------- parameters

def param_shapes(width: int = 64, channels: int = 256) -> dict:
    """{name: shape} of every weight and BN statistic, in module order.
    BN entries: `.weight`, `.bias`, `.running_mean`, `.running_var`."""
    shapes = {}

    def conv(name, cout, cin, k, bias=False):
        shapes[name + ".weight"] = (cout, cin, k, k)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def bn(name, c):
        for key in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{key}"] = (c,)

    w = width
    conv(BACKBONE + "conv1", w, 3, 7)
    bn(BACKBONE + "bn1", w)
    cin = w
    for li, (blocks, planes) in enumerate(zip(BLOCKS, (w, 2 * w, 4 * w))):
        for bi in range(blocks):
            p = f"{BACKBONE}layer{li + 1}.{bi}."
            conv(p + "conv1", planes, cin, 1)
            bn(p + "bn1", planes)
            conv(p + "conv2", planes, planes, 3)
            bn(p + "bn2", planes)
            conv(p + "conv3", 4 * planes, planes, 1)
            bn(p + "bn3", 4 * planes)
            if bi == 0:
                conv(p + "downsample.0", 4 * planes, cin, 1 if li == 0 else 3)
                bn(p + "downsample.1", 4 * planes)
            cin = 4 * planes
    conv("neck.downsample.0", channels, cin, 1)
    bn("neck.downsample.1", channels)
    c = channels
    for branch in ("cls_encode", "reg_encode"):
        for name, _ in ENCODERS:
            for side in ("k", "s"):
                conv(f"{HEAD}{branch}.{name}_{side}.0", c, c, 3)
                bn(f"{HEAD}{branch}.{name}_{side}.1", c)
    shapes[HEAD + "cls_dw.weight"] = (3,)
    shapes[HEAD + "reg_dw.weight"] = (3,)
    for gen in ("conf_gen", "value_gen"):
        conv(f"{HEAD}conf_fusion.{gen}.0", c, c, 3, bias=True)
        bn(f"{HEAD}conf_fusion.{gen}.1", c)
    for tower in ("bbox_tower", "cls_tower", "cls_memory_tower"):
        for i in range(4):
            conv(f"{HEAD}{tower}.{3 * i}", c, c, 3, bias=True)
            bn(f"{HEAD}{tower}.{3 * i + 1}", c)
    conv(HEAD + "bbox_pred", 4, c, 3, bias=True)
    conv(HEAD + "cls_pred", 1, c, 3, bias=True)
    conv(HEAD + "cls_memory_pred", 1, c, 3, bias=True)
    shapes[HEAD + "adjust"] = (1,)
    shapes[HEAD + "bias"] = (1, 4, 1, 1)
    return shapes


# ------------------------------------------------------------- helpers

def prpool(feat, boxes, out: int = 7):
    """Precise RoI pooling: the mean of the bilinear interpolant of `feat`
    (N, C, H, W), zero outside the grid, over each of out x out equal bins
    of the box (N, 4) [x1, y1, x2, y2] in cell coordinates. The
    interpolant is a sum of tents max(0, 1 - |t - g|) per grid line g, so
    a bin's integral is a product of two 1-D tent integrals. A box of no
    area pools to zeros."""
    n, _, h, w = feat.shape
    boxes = boxes.to(feat.dtype)
    x1, y1 = boxes[:, 0], boxes[:, 1]
    bw = torch.clamp(boxes[:, 2] - x1, min=0.0)
    bh = torch.clamp(boxes[:, 3] - y1, min=0.0)

    def tent_area(lo, hi, size):
        # integral over [lo, hi] of max(0, 1 - |t - g|) for g = 0..size-1
        g = torch.arange(size, dtype=feat.dtype, device=feat.device)

        def prim(t):  # antiderivative of the tent, clamped to its support
            t = torch.clamp(t, -1.0, 1.0)
            return t - 0.5 * t * t.abs()
        return prim(hi[..., None] - g) - prim(lo[..., None] - g)

    k = torch.arange(out, dtype=feat.dtype, device=feat.device)
    xs = x1[:, None] + bw[:, None] / out * k        # (N, out) bin starts
    ys = y1[:, None] + bh[:, None] / out * k
    ax = tent_area(xs, xs + (bw / out)[:, None], w)  # (N, out, W)
    ay = tent_area(ys, ys + (bh / out)[:, None], h)  # (N, out, H)
    pooled = torch.einsum("nchw,nph,nqw->ncpq", feat, ay, ax)
    area = bw * bh / (out * out)
    safe = torch.where(area > 0, area, torch.ones_like(area))
    pooled = pooled / safe[:, None, None, None]
    return torch.where((area > 0)[:, None, None, None], pooled,
                       torch.zeros_like(pooled))


def xcorr_dw(x, k):
    """Depthwise correlation, VALID: x (N, C, H, W), k (N, C, h, w) ->
    (N, C, H - h + 1, W - w + 1)."""
    n, c = x.shape[:2]
    out = F.conv2d(x.reshape(1, n * c, *x.shape[2:]),
                   k.reshape(n * c, 1, *k.shape[2:]), groups=n * c)
    return out.reshape(n, c, *out.shape[2:])


# ----------------------------------------------------------------- net

class Net:
    def __init__(self, weights: dict, mode: str = "eval", q=None):
        if mode not in ("eval", "train", "set"):
            raise ValueError(f"BN mode {mode!r}")
        self.w = weights
        self.mode = mode
        self.q = q
        self.new_stats: dict = {}

    # -- layers --

    def conv(self, x, name, stride=1, padding=0, dilation=1):
        w = self.w[name + ".weight"]
        b = self.w.get(name + ".bias")
        if self.q is None:
            return F.conv2d(x, w, b, stride, padding, dilation)
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding,
                               dilation))

    def bn(self, x, name, train: bool = True):
        """BN `name`; `train` False keeps it on its running statistics in
        train mode (the stem, which training never unfreezes)."""
        scale, shift = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.mode == "eval" or (self.mode == "train" and not train):
            mean = self.w[name + ".running_mean"]
            var = self.w[name + ".running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.mode == "set":
                self.w[name + ".running_mean"] = mean.detach().clone()
                self.w[name + ".running_var"] = var.detach().clone()
            else:
                for key, batch in (("running_mean", mean), ("running_var",
                                                            var)):
                    old = self.new_stats.get(f"{name}.{key}",
                                             self.w[f"{name}.{key}"])
                    self.new_stats[f"{name}.{key}"] = \
                        0.9 * old + 0.1 * batch.detach()
        inv = torch.rsqrt(var + EPS) * scale
        y = (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + shift[None, :, None, None]
        return y if self.q is None else self.q(y)

    def conv_bn(self, x, name, relu=True, **kw):
        y = self.bn(self.conv(x, name + ".0", **kw), name + ".1")
        return F.relu(y) if relu else y

    # -- backbone and neck --

    def bottleneck(self, x, p, stride, pad2, dil2, down_k, down_pad):
        out = F.relu(self.bn(self.conv(x, p + "conv1"), p + "bn1"))
        out = F.relu(self.bn(self.conv(out, p + "conv2", stride, pad2, dil2),
                             p + "bn2"))
        out = self.bn(self.conv(out, p + "conv3"), p + "bn3")
        if down_k is not None:
            x = self.bn(self.conv(x, p + "downsample.0", stride, down_pad),
                        p + "downsample.1")
        return F.relu(out + x)

    def backbone(self, img):
        """img (N, H, W, 3) float -> layer3 (N, 1024, H', W')."""
        x = img.permute(0, 3, 1, 2).to(self.w[BACKBONE + "conv1.weight"].dtype)
        x = self.conv(x, BACKBONE + "conv1", stride=2)
        x = F.relu(self.bn(x, BACKBONE + "bn1", train=False))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(3):
            for bi in range(BLOCKS[li]):
                p = f"{BACKBONE}layer{li + 1}.{bi}."
                if bi:
                    pad = dil = 2 if li == 2 else 1
                    x = self.bottleneck(x, p, 1, pad, dil, None, 0)
                elif li == 0:
                    x = self.bottleneck(x, p, 1, 1, 1, 1, 0)
                elif li == 1:
                    x = self.bottleneck(x, p, 2, 0, 1, 3, 0)
                else:
                    x = self.bottleneck(x, p, 1, 1, 1, 3, 1)
        return x

    def features(self, img):
        """img (N, H, W, 3) -> neck output (N, 256, H', W')."""
        return self.conv_bn(self.backbone(img), "neck.downsample", relu=False)

    def template(self, img, box):
        """Template crops (N, 127, 127, 3) and their boxes on the 15-cell
        axis -> 7x7 template features."""
        return prpool(self.features(img), box)

    # -- head --

    def encode(self, x, branch, side):
        return [self.conv_bn(x, f"{HEAD}{branch}_encode.{name}_{side}",
                             dilation=d)
                for name, d in ENCODERS]

    def group_dw(self, xs, ks, which):
        """sum_s softmax(w)_s * xcorr(x_s, k_s); xs and ks lists of 3."""
        w = torch.softmax(self.w[f"{HEAD}{which}_dw.weight"], dim=0)
        out = 0.0
        for i, (x, k) in enumerate(zip(xs, ks)):
            if self.q is not None:
                x, k = self.q(x), self.q(k)
            out = out + w[i] * xcorr_dw(x, k)
        return out if self.q is None else self.q(out)

    def tower(self, x, name):
        for i in range(4):
            x = F.relu(self.bn(self.conv(x, f"{HEAD}{name}.{3 * i}",
                                         padding=1),
                               f"{HEAD}{name}.{3 * i + 1}"))
        return x

    def offline(self, cls_z, reg_z, cls_x, reg_x):
        """Offline branch on encodings -> (bbox (N, 4, S, S) ltrb,
        cls logits (N, 1, S, S))."""
        reg = self.tower(self.group_dw(reg_x, reg_z, "reg"), "bbox_tower")
        bbox = torch.exp(self.w[HEAD + "adjust"]
                         * self.conv(reg, HEAD + "bbox_pred", padding=1)
                         + self.w[HEAD + "bias"])
        cls = self.tower(self.group_dw(cls_x, cls_z, "cls"), "cls_tower")
        return bbox, 0.1 * self.conv(cls, HEAD + "cls_pred", padding=1)

    def memory(self, cls_x, mem_z, m: int):
        """Memory branch: search encodings cls_x (N, ...) against N*m
        encoded memory kernels mem_z (lane-major) -> logits (N, 1, S, S)."""
        xs = [torch.repeat_interleave(x, m, dim=0) for x in cls_x]
        dw = self.group_dw(xs, mem_z, "cls")            # (N*m, C, S, S)
        conf = self.conv_bn(dw, HEAD + "conf_fusion.conf_gen", padding=1)
        value = self.conv_bn(dw, HEAD + "conf_fusion.value_gen", padding=1)
        n = dw.shape[0] // m
        conf = torch.exp(torch.clamp(conf, -6.0, 4.0))
        conf = conf.reshape(n, m, *conf.shape[1:])
        conf = conf / conf.sum(dim=1, keepdim=True)
        fused = (conf * value.reshape(conf.shape)).sum(dim=1)
        c = self.tower(fused, "cls_memory_tower")
        return 0.1 * self.conv(c, HEAD + "cls_memory_pred", padding=1)
