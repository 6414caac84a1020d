"""Training losses, counterpart of `usot_tpu/train/losses.py` (ref:
lib/models/models.py:42-100): static-shape masked means instead of the
reference's index_select/nonzero gathers.

Each loss takes a process group (`group`, None in one process). With
one, a masked mean divides this rank's sum by the count summed over the
group and scales it by the world size W: `W * sum_local(v * m) /
max(sum_global(m), 1)`, so the mean over ranks (the gradient average of
the data-parallel step) is the global batch's masked mean, as JAX's mesh
step computes it (`usot_tpu/train/losses.py:15-17` over the sharded
batch). The count carries no gradient."""
from __future__ import annotations

import torch
import torch.distributed as dist


def _bce_with_logits(logits, labels):
    """Numerically stable elementwise BCE-with-logits."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def _masked_mean(values, mask, group=None):
    count = torch.sum(mask)
    if group is None:
        return torch.sum(values * mask) / torch.clamp(count, min=1.0)
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return (dist.get_world_size(group) * torch.sum(values * mask)
            / torch.clamp(count, min=1.0))


def weighted_bce(pred_logits, label, group=None):
    """0.5 * mean(BCE | label==1) + 0.5 * mean(BCE | label==0).

    pred_logits and label hold the same number of cells; label in {0, 1}
    (0.5 "ignore" cells fall in neither mask, matching the reference's
    eq(1)/eq(0) selection)."""
    pred = pred_logits.reshape(-1).float()
    lab = label.reshape(-1).float()
    elt = _bce_with_logits(pred, lab)
    pos = (lab == 1.0).float()
    neg = (lab == 0.0).float()
    return (0.5 * _masked_mean(elt, pos, group)
            + 0.5 * _masked_mean(elt, neg, group))


def iou_loss(bbox_pred, reg_target, reg_weight, group=None):
    """Mean -log(IoU) over positive cells.

    bbox_pred: (B, H, W, 4) ltrb offsets (positive distances);
    reg_target: (B, H, W, 4); reg_weight: (B, H, W) in {0, 1}."""
    pred = bbox_pred.reshape(-1, 4).float()
    target = reg_target.reshape(-1, 4).float()
    w = reg_weight.reshape(-1).float()

    pl, pt, pr, pb = pred.unbind(1)
    tl, tt, tr, tb = target.unbind(1)

    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    inter = w_inter * h_inter
    union = target_area + pred_area - inter
    # Masked-out cells carry negative ltrb targets; the reference gathers
    # positives before the log and never evaluates them. Select a safe
    # ratio there (NaN * 0 would otherwise poison the masked mean).
    ratio = (inter + 1.0) / (union + 1.0)
    safe_ratio = torch.where(w > 0, ratio, torch.ones_like(ratio))
    losses = -torch.log(torch.clamp(safe_ratio, min=1e-10))
    return _masked_mean(losses, w, group)
