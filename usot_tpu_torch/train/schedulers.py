"""Per-epoch LR schedules: the port's own copy of
`usot_tpu/train/schedulers.py` (ref: lib/utils/train_utils.py:186-323).

Each builder returns a NumPy array lr_spaces[epoch]; the USOT recipe is
step-warmup (0.0025 -> 0.005 over 5 epochs) followed by log decay to 2e-5.
Per-group ratios (e.g. 0.1x backbone) are applied in the optimizer, so
these spaces are the *base* LR trajectory.
"""
from __future__ import annotations

import math

import numpy as np


def log_space(start_lr, end_lr, epochs, **_):
    return np.logspace(math.log10(start_lr), math.log10(end_lr), epochs)


def step_space(start_lr=0.01, end_lr=None, step=10, mult=0.1, epochs=50, **_):
    if end_lr is not None:
        if start_lr is None:
            start_lr = end_lr / (mult ** (epochs // step))
        else:
            mult = math.pow(end_lr / start_lr, 1.0 / (epochs // step))
    return start_lr * (mult ** (np.arange(epochs) // step))


def multi_step_space(start_lr=0.01, end_lr=None, steps=(10, 20, 30, 40),
                     mult=0.5, epochs=50, **_):
    steps = list(steps)
    if end_lr is not None:
        if start_lr is None:
            start_lr = end_lr / (mult ** len(steps))
        else:
            mult = math.pow(end_lr / start_lr, 1.0 / len(steps))
    lr = [0.0] * epochs
    lr[0] = start_lr
    for i in range(1, epochs):
        lr[i] = lr[i - 1]
        if i in steps:
            lr[i] *= mult
    return np.array(lr, np.float64)


def linear_space(start_lr=0.01, end_lr=0.005, epochs=50, **_):
    return np.linspace(start_lr, end_lr, epochs)


def cos_space(start_lr=0.01, end_lr=0.005, epochs=50, **_):
    index = np.arange(epochs, dtype=np.float64)
    return end_lr + (start_lr - end_lr) * (1 + np.cos(index * np.pi / epochs)) * 0.5


_SPACES = {
    "log": log_space,
    "step": step_space,
    "multi-step": multi_step_space,
    "linear": linear_space,
    "cos": cos_space,
}


def build_lr_spaces(train_cfg, epochs: int) -> np.ndarray:
    """train_cfg is cfg.USOT.TRAIN; returns lr per epoch (0-indexed)."""
    if train_cfg.WARMUP.IFNOT:
        warm_epochs = train_cfg.WARMUP.EPOCH
        warm = _SPACES[train_cfg.WARMUP.TYPE](
            epochs=warm_epochs, **train_cfg.WARMUP.KWARGS)
        normal = _SPACES[train_cfg.LR.TYPE](
            epochs=epochs - warm_epochs, **train_cfg.LR.KWARGS)
        return np.concatenate([warm, normal])
    return _SPACES[train_cfg.LR.TYPE](epochs=epochs, **train_cfg.LR.KWARGS)
