"""USOT model: backbone + neck + correlation heads, inference and training
paths.

Counterpart of `usot_tpu/models/usot.py:27-335` (ref:
lib/models/models.py). Submodules carry the reference state-dict names
(`features.features.*`, `neck.downsample.*`, `connect_model.*`), so
`load_state_dict` takes a published `USOT*.pth` (after prefix stripping)
or `usot_tpu.models.convert.invert_usot_checkpoint(variables)` directly;
numpy values are accepted. Public methods take and return NHWC tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.core.geometry import feature_axis, score_grid
from usot_tpu_torch.models.backbone import ResNet50
from usot_tpu_torch.models.head import BoxTowerReg, GroupDW
from usot_tpu_torch.models.layers import (BatchNorm, Conv2d, cast_param,
                                         compute_dtype)
from usot_tpu_torch.models.neck import AdjustLayer
from usot_tpu_torch.ops.prroi import prroi_pool_same_batch
from usot_tpu_torch.train.losses import iou_loss, weighted_bce


STRIDE = 8  # backbone output stride


def pred_offset_to_image_bbox(bbox_pred, search_size: int, score_size: int,
                              stride: int = STRIDE):
    """ltrb offsets (N, S, S, 4) -> image-axis corners (N, S, S, 4)."""
    gx, gy = score_grid(score_size, stride, search_size)
    gx = torch.as_tensor(gx, device=bbox_pred.device)[None]
    gy = torch.as_tensor(gy, device=bbox_pred.device)[None]
    return torch.stack([gx - bbox_pred[..., 0], gy - bbox_pred[..., 1],
                        gx + bbox_pred[..., 2], gy + bbox_pred[..., 3]],
                       dim=-1)


def image_bbox_to_prpool_bbox(image_bbox, search_size: int, sf_size: int,
                              stride: int = STRIDE):
    """Image-axis bbox -> search-feature-axis bbox with the reference's
    2-cell overshoot clamp (ref: lib/models/models.py:150-162)."""
    axis = feature_axis(sf_size, stride, search_size)
    reg_min = float(axis[0])
    reg_max = float(axis[-1])
    gap = (reg_max - reg_min) / (2 * (sf_size // 2))
    clipped = torch.clamp(image_bbox, reg_min - 2 * gap, reg_max + 2 * gap)
    return (clipped - reg_min) / gap


class USOTNet(nn.Module):
    """Single-object tracker (USOT*).

    Inference methods: `template_features`, `search_features`,
    `track_offline`, `track_memory(_batched)`, `encode_template`,
    `encode_memory_kernels`, `track_memory_encoded(_batched|_fused)`,
    `pool_memory_feature`. Training method: `forward_train`.
    `fused_xcorr=True` sends the three GroupDW correlations of a frame to
    the hand-written CUDA kernel on a GPU (inference only: the kernel has
    no backward). `dtype`: the compute dtype (flax's `USOTNet.dtype`);
    torch.bfloat16 runs the network in bfloat16 over float32 parameters
    and BN statistics (see `models/layers.py`). Inputs may come in any
    float dtype: the stem and PrRoIPool cast them; outputs come in the
    compute dtype. `search_size` and `sf_size`: training's search crop
    and its feature map (255 and 25; flax's fields of the same names),
    which the cycle-memory branch maps boxes between."""

    def __init__(self, mem_size: int = 4, fused_xcorr: bool = False,
                 width: int = 64, channels: int = 256,
                 dtype: torch.dtype = torch.float32, search_size: int = 255,
                 sf_size: int = 25):
        super().__init__()
        self.mem_size = mem_size  # training's memory frames; not read here
        self.search_size, self.sf_size = search_size, sf_size
        self.features = ResNet50(width, dtype)
        self.neck = AdjustLayer(16 * width, channels)
        self.connect_model = BoxTowerReg(channels, 4, fused_xcorr)

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        """Accepts numpy values (the converters' output) as well as tensors."""
        state = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
                 for k, v in state_dict.items()}
        return super().load_state_dict(state, strict=strict, assign=assign)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (see `models.layers.compute_dtype`)."""
        stem = self.features.features
        return compute_dtype(stem.dtype, stem.conv1.weight)

    @torch.no_grad()
    def cast_weights(self) -> "USOTNet":
        """Cast every convolution's weight and bias and the bbox head's
        `adjust` and `bias` to the compute dtype now, and take GroupDW's
        softmax, once per checkpoint (a cast is a no-op in the parameters'
        own dtype): the engines and runners call it at construction, so
        no frame step launches either. A copy is made again only after
        its parameter changes."""
        dtype = self.dtype
        for module in self.modules():
            if isinstance(module, Conv2d):
                cast_param(module, "weight", dtype)
                if module.bias is not None:
                    cast_param(module, "bias", dtype)
        for name in ("adjust", "bias"):
            cast_param(self.connect_model, name, dtype)
        for dw in (self.connect_model.cls_dw, self.connect_model.reg_dw):
            dw.scales(dtype)
        return self

    # ---------------- inference API ----------------

    def template_features(self, z, template_bbox):
        """z: (B, 127, 127, 3); template_bbox: (B, 4) on the 15x15 axis.
        Returns zf (B, 7, 7, C) PrPooled by the pseudo bbox."""
        _, zf = self.neck(self.features(z), crop=True, pr_pool=True,
                          bbox=template_bbox)
        return zf

    def search_features(self, x):
        """x: (B, S, S, 3) -> xf (B, s, s, C)."""
        return self.neck(self.features(x), crop=False)

    def track_offline(self, xf, zf):
        """Returns (cls (B,S,S,1), bbox (B,S,S,4))."""
        bbox, cls, _, _ = self.connect_model.offline(xf, zf)
        return cls, bbox

    def track_memory(self, xf, zf, template_mem):
        """Offline + online modules; template_mem: (N_q, 7, 7, C) memory
        queue (batch size 1). Returns (cls, bbox, cls_mem)."""
        bbox, cls, cls_x, _ = self.connect_model.offline(xf, zf)
        cls_mem = self.connect_model.memory_cls(
            cls_x, template_mem, mem_size=template_mem.shape[0])
        return cls, bbox, cls_mem

    def track_memory_batched(self, xf, zf, template_mem):
        """B videos at once: xf (B, s, s, C); zf (B, 7, 7, C);
        template_mem (B, N_q, 7, 7, C)."""
        bbox, cls, cls_x, _ = self.connect_model.offline(xf, zf)
        b, n_q = template_mem.shape[0], template_mem.shape[1]
        mem_flat = template_mem.reshape((b * n_q,)
                                        + tuple(template_mem.shape[2:]))
        cls_mem = self.connect_model.memory_cls(cls_x, mem_flat, mem_size=n_q)
        return cls, bbox, cls_mem

    # -- pre-encoded-kernel variants: the kernel-side encodings of the
    # template and of each pooled memory frame are computed once and
    # carried (ref re-encodes them every frame, connect.py:229-255) --

    def encode_memory_kernels(self, feat):
        """feat: (N, 7, 7, C) -> tuple of 3 cls-side encodings (N, h, w, C)."""
        return tuple(self.connect_model.encode_kernel(feat)[0])

    def encode_template(self, zf):
        """zf: (B, 7, 7, C) -> (cls_z 3-tuple, reg_z 3-tuple)."""
        cls_z, reg_z = self.connect_model.encode_kernel(zf)
        return tuple(cls_z), tuple(reg_z)

    def track_memory_encoded(self, xf, zf_enc, queue_enc):
        """track_memory with cached encodings (batch size 1): zf_enc
        (cls_z, reg_z) 3-tuples of (1, h, w, C); queue_enc 3-tuple of
        (N_q, h_i, w_i, C). Returns (cls, bbox, cls_mem)."""
        cls_z, reg_z = zf_enc
        bbox, cls, cls_x, _ = self.connect_model.offline_preenc(
            xf, list(cls_z), list(reg_z))
        cls_mem = self.connect_model.memory_cls_preenc(
            cls_x, list(queue_enc), mem_size=queue_enc[0].shape[0])
        return cls, bbox, cls_mem

    def track_memory_encoded_batched(self, xf, zf_enc, queue_enc):
        """Batched: xf (B, s, s, C); zf_enc tensors (B, h, w, C);
        queue_enc 3-tuple of (B, N_q, h_i, w_i, C)."""
        cls_z, reg_z = zf_enc
        bbox, cls, cls_x, _ = self.connect_model.offline_preenc(
            xf, list(cls_z), list(reg_z))
        b, n_q = queue_enc[0].shape[0], queue_enc[0].shape[1]
        flat = [q.reshape((b * n_q,) + tuple(q.shape[2:])) for q in queue_enc]
        cls_mem = self.connect_model.memory_cls_preenc(cls_x, flat,
                                                       mem_size=n_q)
        return cls, bbox, cls_mem

    def track_memory_encoded_fused(self, xf, zf_enc, queue_enc, fused):
        """track_memory_encoded on FOLDED inference-head weights
        (`fused` from `models.head.fold_inference_head`, computed once
        per checkpoint): 3 double-wide search-encoder convs instead of
        6 and one ConfFusion conv instead of 2, no BN ops. queue_enc
        tensors are (B, N_q, h_i, w_i, C), or (N_q, h_i, w_i, C) at
        batch size 1."""
        cls_z, reg_z = zf_enc
        bbox, cls, cls_x = self.connect_model.offline_fused_enc(
            xf, (cls_z, reg_z), fused)
        if queue_enc[0].dim() == 5:
            b, n_q = queue_enc[0].shape[0], queue_enc[0].shape[1]
            flat = [q.reshape((b * n_q,) + tuple(q.shape[2:]))
                    for q in queue_enc]
        else:
            n_q, flat = queue_enc[0].shape[0], list(queue_enc)
        cls_mem = self.connect_model.memory_cls_fused(cls_x, flat, n_q,
                                                      fused)
        return cls, bbox, cls_mem

    def pool_memory_feature(self, xf, search_bbox):
        """PrPool (B, 7, 7, C) memory features from search features by a
        feature-axis bbox (ref: models.py:200-206)."""
        return prroi_pool_same_batch(xf, search_bbox, pooled=7)

    # ---------------- training ----------------

    def forward_train(self, template, search, label, reg_target, reg_weight,
                      template_bbox, search_memory=None, search_bbox=None,
                      cls_ratio=0.4, stage_bn_train: bool = False,
                      remat: bool = False, group=None):
        """Returns (cls_loss_ori, cls_loss_memory | None, reg_loss).

        template: (B, 127, 127, 3); search: (B, 255, 255, 3);
        label: (B, 25, 25); reg_target: (B, 25, 25, 4); reg_weight:
        (B, 25, 25); template_bbox: (B, 4) on the template feature axis
        (15x15); search_memory: (B, M, 255, 255, 3) or None (naive
        Siamese phase); search_bbox: (B, 4) on the search feature axis.

        Train-mode BN updates its running stats in place at every call,
        so the modules run in `usot_tpu`'s order (template, search, then
        the memory frames through the backbone and the neck; the offline
        head on the search, then on the memory frames; the memory head
        forward, then backward): the stats come out as flax's do. The
        memory frames get their own backbone call, never one concatenated
        with the search images, whose batch statistics would differ.
        remat: the backbone's bottlenecks are recomputed in backward (see
        `ResNetPlus2.forward`); the values are the same. group: the
        data-parallel process group the losses' masked means count over
        (`train/losses.py`); the BNs take theirs from `BatchNorm.group`."""
        if self.connect_model.fused_xcorr:
            raise ValueError("forward_train needs fused_xcorr=False: the "
                             "GroupDW kernel has no backward")
        bn = True  # neck/head BN are always in train mode during training
        head = self.connect_model
        zf_raw = self.features(template, stage_bn_train=stage_bn_train,
                               remat=remat)
        xf_raw = self.features(search, stage_bn_train=stage_bn_train,
                               remat=remat)
        _, zf = self.neck(zf_raw, bn_train=bn, crop=True, pr_pool=True,
                          bbox=template_bbox)
        xf = self.neck(xf_raw, bn_train=bn, crop=False)

        bbox_pred, cls_pred, cls_x, _ = head.offline(xf, zf, bn_train=bn)
        reg_loss = iou_loss(bbox_pred, reg_target, reg_weight, group)
        cls_loss_ori = weighted_bce(cls_pred, label, group)
        if search_memory is None:
            return cls_loss_ori, None, reg_loss

        # ---- cycle memory branch (ref: models.py:232-286) ----
        b, m = search_memory.shape[0], search_memory.shape[1]
        mem_flat = search_memory.reshape((b * m,)
                                         + tuple(search_memory.shape[2:]))
        xf_mem = self.neck(
            self.features(mem_flat, stage_bn_train=stage_bn_train,
                          remat=remat),
            bn_train=bn, crop=False)

        # online kernel: the template frame's search feature pooled by
        # the pseudo bbox; lanes b*m + j repeat sample b
        spf = prroi_pool_same_batch(xf, search_bbox, pooled=7)
        spf_rep = torch.repeat_interleave(spf, m, dim=0)
        zf_rep = torch.repeat_interleave(zf, m, dim=0)

        # forward-track into the memory frames with the offline module,
        # and with the online module (one kernel per memory frame)
        off_bbox, off_cls, fwd_x_store, _ = head.offline(xf_mem, zf_rep,
                                                         bn_train=bn)
        mem_cls = head.memory_cls(fwd_x_store, spf_rep, mem_size=1,
                                  bn_train=bn)
        # in float32 whatever the compute dtype: JAX's step passes
        # cls_ratio as a float32 array, which promotes the bf16 maps
        s = off_cls.shape[1]  # score size
        forward_res = (cls_ratio * off_cls.reshape(b, m, s * s).float()
                       + (1.0 - cls_ratio)
                       * mem_cls.reshape(b, m, s * s).float())
        best_idx = torch.argmax(forward_res, dim=2)  # (B, M), first max

        img_bbox = pred_offset_to_image_bbox(off_bbox, self.search_size, s)
        img_bbox = img_bbox.reshape(b, m, s * s, 4)
        best_bbox = torch.gather(
            img_bbox, 2, best_idx[:, :, None, None].expand(b, m, 1, 4))
        pool_bbox = image_bbox_to_prpool_bbox(
            best_bbox.reshape(b * m, 4), self.search_size,
            self.sf_size).detach()

        pooled_mem = prroi_pool_same_batch(xf_mem, pool_bbox, pooled=7)
        # backward-track to the template frame's search area
        backward_res = head.memory_cls(cls_x, pooled_mem, mem_size=m,
                                       bn_train=bn)
        cls_loss_mem = weighted_bce(backward_res, label, group)
        return cls_loss_ori, cls_loss_mem, reg_loss


def build_usot(mem_size: int = 4, dtype: torch.dtype = torch.float32,
               **kwargs) -> USOTNet:
    """The model definition, on the CPU with torch's default init; give it
    weights with `init_model` or `load_state_dict`. `dtype` is the compute
    dtype (torch.float32 or torch.bfloat16); the parameters are float32
    either way. Never `model.to(torch.bfloat16)`: that would round the BN
    statistics."""
    return USOTNet(mem_size=mem_size, dtype=dtype, **kwargs)


def lecun_normal_(w, generator):
    """flax's lecun_normal: truncated normal on [-2, 2] standard
    deviations, std sqrt(1 / fan_in) / 0.8796... (fan_in = I*kh*kw)."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    w.copy_(draw)


@torch.no_grad()
def init_model(model: USOTNet, generator: torch.Generator | None = None,
               device=None) -> USOTNet:
    """Draw flax's init distributions into `model` and move it to `device`
    (default: the GPU; raises without one unless device="cpu").

    Conv kernels lecun-normal with zero bias, BN scale 1 / bias 0 /
    mean 0 / var 1, GroupDW weights ones, adjust 0.1, bbox bias ones.
    Draws come from `generator` (a CPU torch.Generator; seed 0 if None)
    in module order, so a seed gives the same weights on every device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.to(dev)
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            lecun_normal_(module.weight, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            module.num_batches_tracked.zero_()
        elif isinstance(module, GroupDW):
            module.weight.fill_(1.0)
        elif isinstance(module, BoxTowerReg):
            module.adjust.fill_(0.1)
            module.bias.fill_(1.0)
    return model.eval()
