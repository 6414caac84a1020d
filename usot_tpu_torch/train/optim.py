"""Staged optimizer: SGD + momentum + weight decay with per-group LR
multipliers and backbone freeze/unfreeze. Counterpart of
`usot_tpu/train/optim.py` (ref: scripts/train_usot.py:72-135).

Groups (by parameter name):
  frozen   — `requires_grad=False`, in no group (the backbone before
             UNFIX_EPOCH; the stem always)
  backbone — trainable backbone stages, LR x LAYERS_LR
  base     — neck + head, LR x 1

torch's SGD with momentum m, dampening 0 and weight decay wd keeps
`buf = m * buf + (g + wd * p)` (the gradient itself on the first step)
and steps `p -= lr * buf`: optax's `add_decayed_weights -> trace ->
scale(mult)` with the update scaled by -lr, whose trace starts at zero.
The base LR is set into the groups every step (`set_lr`); the optimizer
is rebuilt only at the UNFIX_EPOCH stage boundary, as in the reference.
"""
from __future__ import annotations

import torch

TRAINABLE_LAYERS = ("layer1", "layer2", "layer3")


def label_params(model, unfix: bool, trainable_layers=TRAINABLE_LAYERS):
    """{parameter name: 'frozen' | 'backbone' | 'base'}."""
    labels = {}
    for name, _ in model.named_parameters():
        if name.startswith("features."):
            # features.features.{conv1,bn1,layerN}.…
            scope = name.split(".")[2]
            labels[name] = ("backbone" if unfix and scope in trainable_layers
                            else "frozen")
        else:
            labels[name] = "base"
    return labels


def build_optimizer(model, momentum: float, weight_decay: float,
                    layers_lr_mult: float, unfix: bool,
                    trainable_layers=TRAINABLE_LAYERS):
    """Sets `requires_grad` by label and returns (SGD over the backbone
    and base groups, labels). Each group carries its `lr_mult`."""
    labels = label_params(model, unfix, trainable_layers)
    groups = {"backbone": [], "base": []}
    for name, p in model.named_parameters():
        label = labels[name]
        p.requires_grad_(label != "frozen")
        if label != "frozen":
            groups[label].append(p)
    param_groups = [{"params": groups[g], "name": g, "lr_mult": mult}
                    for g, mult in (("backbone", layers_lr_mult),
                                    ("base", 1.0)) if groups[g]]
    opt = torch.optim.SGD(param_groups, lr=0.0, momentum=momentum,
                          dampening=0.0, weight_decay=weight_decay,
                          nesterov=False)
    return opt, labels


def set_lr(optimizer, lr: float):
    """The epoch's base LR into every group, times its multiplier."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
