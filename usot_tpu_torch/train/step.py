"""The training step: loss, grads, the SGD update and the BN stats, with
the reference's loss weighting schedules and NaN/explosion gate.
Counterpart of `usot_tpu/train/step.py` (ref: scripts/train_usot.py:
138-273, lib/utils/train_utils.py:8-9).

The model and the optimizer hold the state and are updated in place;
BatchNorm's running stats update during the forward, as flax threads
them through `mutable=["batch_stats"]`.
"""
from __future__ import annotations

import torch

from usot_tpu_torch.models.layers import BatchNorm
from usot_tpu_torch.train.optim import set_lr


def epoch_weights(cfg_train, epoch: int):
    """Resolve (lambda1, lambda_total, cls_ratio) for an epoch
    (ref: train_usot.py:180-229)."""
    shift = cfg_train.CLS_RATIO_SHIFT_EPOCHS
    ratios = cfg_train.CLS_RATIOS
    cls_ratio = None
    for i in range(len(shift) - 1):
        if shift[i] <= epoch <= shift[i + 1]:
            cls_ratio = ratios[i]
            break
    if cls_ratio is None:
        cls_ratio = ratios[-1]

    lshift = cfg_train.LAMBDA_SHIFT_EPOCHS
    l1_list = cfg_train.LAMBDA_1_LIST
    lambda1 = None
    for i in range(len(lshift) - 1):
        if lshift[i] <= epoch <= lshift[i + 1]:
            lambda1 = l1_list[i]
            break
    if lambda1 is None:
        lambda1 = l1_list[-1]
    return lambda1, cfg_train.LAMBDA_TOTAL, cls_ratio


def images_f32(x):
    """Accept (.., H, W, 3) float images OR the shard transport layout,
    channel-flat (.., H, W*3) uint8 (4x smaller uploads; see
    `data/shards.py`), and return (.., H, W, 3) f32 on x's device."""
    if x.dtype == torch.uint8:
        x = x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 3, 3))
    return x.float()


def _bn_stats(model):
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def make_train_step(model, optimizer, cycle_memory: bool,
                    stage_bn_train: bool, lambda_1: float,
                    lambda_total: float = 0.9,
                    lambda_1_naive: float = 0.2,
                    remat: bool = False,
                    accum_steps: int = 1):
    """Build the step for one training phase: `step(batch, lr, cls_ratio)
    -> metrics` (0-d tensors on the batch's device: cls_loss_ori,
    cls_loss_memory, reg_loss, loss).

    batch keys: template, search, label, reg_target, reg_weight,
    template_bbox [, search_memory, search_bbox], tensors on the model's
    device. Same math as the plain step under either lever:
    - remat: the backbone's bottlenecks under `torch.utils.checkpoint`
      (non-reentrant), so backward keeps only their inputs and
      recomputes one block at a time, where `jax.checkpoint` wraps the
      whole loss: one checkpoint around the loss recomputes the whole
      forward before the backward starts, and its peak memory is the
      plain step's. The recompute runs the train-mode BNs a second time;
      their running stats are saved after the forward and put back after
      the backward, so they update once, as under `jax.checkpoint`.
    - accum_steps k > 1: k microbatches in turn, each seeing the running
      stats the previous one left; grads summed, then scaled by 1/k, and
      one update.
    The NaN/explosion gate: when the loss is not finite or is >= 1e4,
    params and momentum stay as they were (no `optimizer.step()`); the
    BN running stats keep this step's update, as JAX returns its new
    stats either way. Reading the gate is one host sync per step.
    Every parameter in the optimizer gets a gradient each step, zero where
    the phase does not reach it (the memory head in the naive phase), so
    weight decay and momentum move it as optax moves it.
    Images enter the model in its parameters' dtype (float32 unless the
    caller made the model float64), as JAX's `_images_f32` feeds them;
    a bf16 model's stem casts them to its compute dtype, and the losses
    are float32 (`train/losses.py`). Parameters, BN statistics and the
    optimizer's state stay float32."""
    stats = _bn_stats(model)
    dtype = next(model.parameters()).dtype
    trainable = [p for g in optimizer.param_groups for p in g["params"]]

    def images(x):
        return images_f32(x).to(dtype)

    def loss_fn(batch, cls_ratio):
        common = (images(batch["template"]), images(batch["search"]),
                  batch["label"], batch["reg_target"], batch["reg_weight"],
                  batch["template_bbox"])
        if cycle_memory:
            l_ori, l_mem, l_reg = model.forward_train(
                *common, search_memory=images(batch["search_memory"]),
                search_bbox=batch["search_bbox"], cls_ratio=cls_ratio,
                stage_bn_train=stage_bn_train, remat=remat)
            loss = (lambda_1 * l_ori + (lambda_total - lambda_1) * l_mem
                    + 1.0 * l_reg)
        else:
            l_ori, _, l_reg = model.forward_train(
                *common, stage_bn_train=stage_bn_train, remat=remat)
            l_mem = torch.zeros((), device=l_ori.device)
            loss = lambda_1_naive * l_ori + 1.0 * l_reg
        return loss, l_ori, l_mem, l_reg

    def grads_of(batch, cls_ratio):
        """Backward of one (micro)batch; grads add into `.grad`."""
        out = loss_fn(batch, cls_ratio)
        if not remat:
            out[0].backward()
            return out
        kept = [t.clone() for t in stats]
        out[0].backward()
        with torch.no_grad():
            for t, k in zip(stats, kept):
                t.copy_(k)
        return out

    def step(batch, lr, cls_ratio):
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.zero_grad(set_to_none=False)
        if accum_steps == 1:
            out = grads_of(batch, cls_ratio)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch {n} not divisible by accum_steps "
                                 f"{accum_steps}")
            size = n // accum_steps
            total = None
            for i in range(accum_steps):
                micro = {k: v[i * size:(i + 1) * size]
                         for k, v in batch.items()}
                out = [t.detach() for t in grads_of(micro, cls_ratio)]
                total = out if total is None else [
                    a + b for a, b in zip(total, out)]
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for p in trainable:
                    p.grad.mul_(inv)
            out = [t * inv for t in total]
        loss = out[0].detach()
        # is_valid_number gate (ref: train_utils.py:8-9)
        if bool(torch.isfinite(loss) & (loss < 1e4)):
            set_lr(optimizer, float(lr))
            optimizer.step()
        return {"cls_loss_ori": out[1].detach(),
                "cls_loss_memory": out[2].detach(),
                "reg_loss": out[3].detach(), "loss": loss}

    return step
