"""BN running-stat calibration for randomly initialised models.

Counterpart of `usot_tpu/models/calibrate.py`. Inference normalises with
the BatchNorm running stats; a fresh init (mean 0, var 1) meets raw 0-255
pixels, and at full width the bbox `exp` overflows. A few train-mode
passes on synthetic inputs bootstrap the stats. The passes replay the
module sequence of the JAX package's `USOTNet.forward_train`
(`usot_tpu/models/usot.py:222-281`) without the losses, on the same
seeded numpy inputs, so both packages calibrate to the same stats; the
port's BatchNorm updates them with flax's rule (see models/layers.py).
A bf16 model calibrates in bf16, as JAX's does (`calibrate.py:42`): the
inputs go in float32 and the stem casts them; the stats stay float32.
"""
from __future__ import annotations

import numpy as np
import torch

from usot_tpu_torch.models.usot import (USOTNet, image_bbox_to_prpool_bbox,
                                        pred_offset_to_image_bbox)
from usot_tpu_torch.ops.prroi import prroi_pool_same_batch


def _train_pass(model: USOTNet, t, s, tb, sm, sb, search: int, score: int,
                cls_ratio: float = 0.4):
    """forward_train's module calls in BN-train mode, stem in eval mode."""
    connect = model.connect_model
    zf_raw = model.features(t, stage_bn_train=True)
    xf_raw = model.features(s, stage_bn_train=True)
    _, zf = model.neck(zf_raw, bn_train=True, crop=True, pr_pool=True,
                       bbox=tb)
    xf = model.neck(xf_raw, bn_train=True)
    _, _, cls_x, _ = connect.offline(xf, zf, bn_train=True)

    # cycle memory branch (ref: models.py:232-286)
    b, m = sm.shape[0], sm.shape[1]
    mem_flat = sm.reshape((b * m,) + tuple(sm.shape[2:]))
    xf_mem = model.neck(model.features(mem_flat, stage_bn_train=True),
                        bn_train=True)
    spf = prroi_pool_same_batch(xf, sb, pooled=7)
    spf_rep = torch.repeat_interleave(spf, m, dim=0)
    zf_rep = torch.repeat_interleave(zf, m, dim=0)
    off_bbox, off_cls, fwd_x_store, _ = connect.offline(xf_mem, zf_rep,
                                                        bn_train=True)
    mem_cls = connect.memory_cls(fwd_x_store, spf_rep, mem_size=1,
                                 bn_train=True)
    sc = off_cls.shape[1]
    forward_res = (cls_ratio * off_cls.reshape(b, m, sc * sc)
                   + (1.0 - cls_ratio) * mem_cls.reshape(b, m, sc * sc))
    best_idx = torch.argmax(forward_res, dim=2)                  # (B, M)
    img_bbox = pred_offset_to_image_bbox(off_bbox, search, sc)
    img_bbox = img_bbox.reshape(b, m, sc * sc, 4)
    best_bbox = torch.gather(
        img_bbox, 2, best_idx[..., None, None].expand(b, m, 1, 4))[:, :, 0]
    pool_bbox = image_bbox_to_prpool_bbox(best_bbox.reshape(b * m, 4),
                                          search, score)
    pooled_mem = prroi_pool_same_batch(xf_mem, pool_bbox, pooled=7)
    connect.memory_cls(cls_x, pooled_mem, mem_size=m, bn_train=True)


@torch.no_grad()
def calibrate_batch_stats(model: USOTNet, seed: int = 0, n_iter: int = 30,
                          template: int = 63, search: int = 95,
                          amplitude: float = 255.0) -> USOTNet:
    """Re-estimates `model`'s BN running stats in place on synthetic
    image-scale inputs (momentum 0.9 per pass) and returns it."""
    rng = np.random.default_rng(seed)

    def backbone_out(n):
        stem = (n - 7) // 2 + 1
        pooled = (stem + 2 - 3) // 2 + 1
        return (pooled - 3) // 2 + 1  # layer2 stride; layer1/3 keep size

    score = backbone_out(search) - 6  # head VALID convs + xcorr
    param = next(model.parameters())

    def tensor(a):
        return torch.as_tensor(a, dtype=param.dtype, device=param.device)

    t = tensor(rng.random((2, template, template, 3)).astype(np.float32)
               * amplitude)
    s = tensor(rng.random((2, search, search, 3)).astype(np.float32)
               * amplitude)
    tb = tensor([[2.0, 2.0, 10.0, 10.0]] * 2)
    sm = tensor(rng.random((2, 1, search, search, 3)).astype(np.float32)
                * amplitude)
    sb = tensor([[3.0, 3.0, 8.0, 8.0]] * 2)

    for _ in range(n_iter):
        # backbone pass with the stem in train mode as well
        model.features(s, stem_bn_train=True, stage_bn_train=True)
        _train_pass(model, t, s, tb, sm, sb, search, score)
    return model
