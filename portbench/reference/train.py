"""The cycle-memory training step of USOT* in plain PyTorch (stage 2 of
the published schedule, arXiv 2108.12711 section 3.3; the reference's
`experiments/train/USOT.yaml`), written from the published description:
the losses, their gradients by autograd, SGD with momentum and weight
decay, and the BatchNorm running statistics.

Forward (every BN in train mode but the stem's): the template and the
search image through the backbone and neck; the offline branch on the
template pooled by its box; then cycle memory: the M memory frames
through the backbone and neck, the offline branch and the memory branch
(the search image's target, pooled by its box, as the one kernel) track
forward into each memory frame; each memory frame's best cell of
cls_ratio * offline + (1 - cls_ratio) * memory gives a box (not
differentiated) that pools the memory kernel; the memory branch tracks
back from the M kernels into the search image.
Losses: cls BCE with logits, the mean over positive cells and the mean
over negative cells weighted 1/2 each; reg -log IoU of the ltrb boxes
((inter + 1) / (union + 1)) over the cells of weight 1; total
lambda_1 * cls + (lambda_total - lambda_1) * cls_memory + reg.
Update: SGD, d = g + weight_decay * p, buf = d on the first step and
momentum * buf + d after, p -= lr * multiplier * buf; the stem
(`conv1`, `bn1`) is frozen, the backbone stages take LAYERS_LR times
the rate, the neck and the head the rate itself.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.net import BACKBONE, Net, param_shapes, prpool

STEM = (BACKBONE + "conv1.", BACKBONE + "bn1.")
STATS = ("running_mean", "running_var")


def leaves(width: int, channels: int) -> dict:
    """{trainable leaf name: learning-rate multiplier key} ("backbone" or
    "base"); the stem and every running statistic are left out."""
    out = {}
    for name in param_shapes(width, channels):
        if name.endswith(STATS) or name.startswith(STEM):
            continue
        out[name] = "backbone" if name.startswith(BACKBONE) else "base"
    return out


def bce(logits, label):
    x = logits.reshape(-1)
    y = label.reshape(-1)
    elt = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    pos, neg = (y == 1).float(), (y == 0).float()
    return 0.5 * (elt * pos).sum() / pos.sum().clamp(min=1) \
        + 0.5 * (elt * neg).sum() / neg.sum().clamp(min=1)


def iou_loss(ltrb, target, weight):
    p = ltrb.permute(0, 2, 3, 1).reshape(-1, 4)
    t = target.reshape(-1, 4)
    w = weight.reshape(-1)
    inter = (torch.minimum(p[:, 0], t[:, 0]) + torch.minimum(p[:, 2], t[:, 2])) \
        * (torch.minimum(p[:, 1], t[:, 1]) + torch.minimum(p[:, 3], t[:, 3]))
    union = (p[:, 0] + p[:, 2]) * (p[:, 1] + p[:, 3]) \
        + (t[:, 0] + t[:, 2]) * (t[:, 1] + t[:, 3]) - inter
    ratio = torch.where(w > 0, (inter + 1) / (union + 1),
                        torch.ones_like(inter))
    return (-torch.log(ratio.clamp(min=1e-10)) * w).sum() / w.sum().clamp(
        min=1)


def image_boxes(ltrb, search: int, stride: int = 8):
    """(N, 4, S, S) ltrb -> (N, S*S, 4) image-axis boxes on the search
    crop's score grid."""
    s = ltrb.shape[-1]
    g = (torch.arange(s, dtype=ltrb.dtype, device=ltrb.device) - s // 2) \
        * stride + search // 2
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    box = torch.stack([gx - ltrb[:, 0], gy - ltrb[:, 1],
                       gx + ltrb[:, 2], gy + ltrb[:, 3]], dim=-1)
    return box.reshape(ltrb.shape[0], -1, 4)


def forward(net: Net, b: dict, cls_ratio: float, search: int = 255,
            feat: int = 25):
    """The three losses (cls, cls_memory, reg) of one batch `b` (NHWC
    float32 images, the maps and boxes of the training sample)."""
    zf_raw = net.backbone(b["template"])
    xf_raw = net.backbone(b["search"])
    zf = prpool(net.conv_bn(zf_raw, "neck.downsample", relu=False),
                b["template_bbox"])
    xf = net.conv_bn(xf_raw, "neck.downsample", relu=False)

    def offline(x, z):
        cls_z, reg_z = net.encode(z, "cls", "k"), net.encode(z, "reg", "k")
        cls_x, reg_x = net.encode(x, "cls", "s"), net.encode(x, "reg", "s")
        bbox, cls = net.offline(cls_z, reg_z, cls_x, reg_x)
        return bbox, cls, cls_x

    bbox, cls, cls_x = offline(xf, zf)
    reg_loss = iou_loss(bbox, b["reg_target"], b["reg_weight"])
    cls_loss = bce(cls, b["label"])

    n, m = b["search_memory"].shape[:2]
    mem = b["search_memory"].reshape(n * m, *b["search_memory"].shape[2:])
    xf_mem = net.conv_bn(net.backbone(mem), "neck.downsample", relu=False)
    target = prpool(xf, b["search_bbox"])
    f_bbox, f_cls, f_cls_x = offline(xf_mem,
                                     torch.repeat_interleave(zf, m, dim=0))
    f_mem = net.memory(f_cls_x, net.encode(
        torch.repeat_interleave(target, m, dim=0), "cls", "k"), 1)
    s = f_cls.shape[-1]
    blend = cls_ratio * f_cls.reshape(n, m, s * s) \
        + (1 - cls_ratio) * f_mem.reshape(n, m, s * s)
    best = blend.argmax(dim=2).reshape(-1)
    box = image_boxes(f_bbox, search)[torch.arange(n * m), best]
    lo = float((0 - feat // 2) * 8 + search // 2)
    hi = float((feat - 1 - feat // 2) * 8 + search // 2)
    gap = (hi - lo) / (2 * (feat // 2))
    cells = ((box.clamp(lo - 2 * gap, hi + 2 * gap) - lo) / gap).detach()
    back = net.memory(cls_x, net.encode(prpool(xf_mem, cells), "cls", "k"), m)
    return cls_loss, bce(back, b["label"]), reg_loss


def train(weights: dict, batches: list, hp: dict, steps: int):
    """`steps` steps from `weights` (float32 tensors, not changed) over
    `batches` in turn. hp: lr, cls_ratio, lambda_1, lambda_total,
    momentum, weight_decay, layers_lr, width, channels. Returns
    {"loss": [per step: cls, cls_memory, reg, total], "grad1": {leaf:
    the first step's gradient}, "params": {leaf: value after the last
    step}, "stats": {BN statistic: value after the last step}}."""
    names = leaves(hp["width"], hp["channels"])
    mult = {"backbone": hp["layers_lr"], "base": 1.0}
    state = {k: v.detach().clone() for k, v in weights.items()}
    bufs, out = {}, {"loss": []}
    for i in range(steps):
        params = {k: state[k].clone().requires_grad_(True) for k in names}
        net = Net({**state, **params}, mode="train")
        cls, mem, reg = forward(net, batches[i % len(batches)],
                                hp["cls_ratio"])
        total = hp["lambda_1"] * cls \
            + (hp["lambda_total"] - hp["lambda_1"]) * mem + reg
        grads = torch.autograd.grad(total, [params[k] for k in names])
        out["loss"].append([float(t) for t in (cls, mem, reg, total)])
        if i == 0:
            out["grad1"] = {k: g.detach() for k, g in zip(names, grads)}
        state.update({k: v.detach() for k, v in net.new_stats.items()})
        if not np.isfinite(out["loss"][-1][3]) or out["loss"][-1][3] >= 1e4:
            continue  # the reference's gate: no update on a bad loss
        with torch.no_grad():
            for k, g in zip(names, grads):
                d = g + hp["weight_decay"] * state[k]
                bufs[k] = d if k not in bufs else hp["momentum"] * bufs[k] + d
                state[k] = state[k] - hp["lr"] * mult[names[k]] * bufs[k]
    out["params"] = {k: state[k] for k in names}
    out["stats"] = {k: v for k, v in state.items() if k.endswith(STATS)}
    return out
