"""Checkpoint save/restore, counterpart of `usot_tpu/train/checkpoint.py`
(ref: lib/utils/train_utils.py:74-180).

Format: the original torch repo's own, `torch.save` of
{"epoch", "arch", "state_dict", "optimizer"} as
`checkpoint_e{N}.pth` under CHECKPOINT_DIR, saved from epoch 5 on like
the reference's save_model. The state dict has the reference key layout,
so the port's test CLI (`--resume`) and `usot_tpu`'s
`load_torch_state_dict` / `load_variables` read these files too.
"""
from __future__ import annotations

import os

import torch


def save_checkpoint(directory: str, model, optimizer, epoch: int,
                    arch: str = "USOT") -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_e{epoch}.pth")
    torch.save({"epoch": int(epoch), "arch": arch,
                "state_dict": model.state_dict(),
                "optimizer": optimizer.state_dict()}, path)
    return path


def save_model_epoch(directory: str, model, optimizer, epoch: int,
                     arch: str = "USOT") -> str | None:
    """Reference semantics: only persist from epoch 5 on
    (ref: train_utils.py:82-84)."""
    if epoch < 5:
        return None
    return save_checkpoint(directory, model, optimizer, epoch, arch)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def peek_epoch(path: str) -> int:
    """The epoch tag of a checkpoint. The resume path reads it first to
    rebuild the optimizer for the checkpoint's freeze stage (its groups
    differ across UNFIX_EPOCH) before loading the optimizer state."""
    return int(_load(path)["epoch"])


def restore_checkpoint(path: str, model, optimizer) -> int:
    """Load params, BN stats and the optimizer state (momentum buffers)
    in place; `optimizer` must be built for the checkpoint's stage.
    Returns the epoch."""
    state = _load(path)
    model.load_state_dict(state["state_dict"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
