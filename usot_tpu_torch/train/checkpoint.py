"""Checkpoint save/restore, counterpart of `usot_tpu/train/checkpoint.py`
(ref: lib/utils/train_utils.py:74-180).

Format: the original torch repo's own, `torch.save` of
{"epoch", "arch", "state_dict", "optimizer"} as
`checkpoint_e{N}.pth` under CHECKPOINT_DIR, saved from epoch 5 on like
the reference's save_model. The state dict has the reference key layout,
so the port's test CLI (`--resume`) and `usot_tpu`'s
`load_torch_state_dict` / `load_variables` read these files too.

The port also reads `usot_tpu`'s own files, as its `load_variables` does
(`usot_tpu/train/checkpoint.py:73-84`): a path ending in `.pth`,
`.model` or `.tar` is a torch file, anything else a flax msgpack file
(`checkpoint_eN.ckpt`: {params, batch_stats, opt_state, epoch, arch};
an inference `.msgpack`: {params, batch_stats, ...}), read by
`utils/msgpack.py`. A training checkpoint's optax state maps onto the
optimizer's momentum buffers (`restore_checkpoint`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from usot_tpu_torch.models.convert import state_dict_from_flax, strip_prefix
from usot_tpu_torch.utils.msgpack import read_msgpack

TORCH_SUFFIXES = (".pth", ".model", ".tar")


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


def is_torch_file(path: str) -> bool:
    return path.endswith(TORCH_SUFFIXES)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _numpy(tree):
    """A restored flax tree with float32 numpy leaves (a bfloat16 leaf
    comes back from the reader as a torch tensor)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.float().numpy()
    return tree


def load_model_state(path: str):
    """The reference-layout state dict of a checkpoint, torch or flax
    (counterpart of `usot_tpu`'s `load_variables`): a torch file's
    `state_dict` (or the file itself) with its prefixes stripped; a flax
    file's {params, batch_stats} through `state_dict_from_flax`."""
    if is_torch_file(path):
        state = torch.load(path, map_location="cpu")
        return strip_prefix(state.get("state_dict", state))
    restored = read_msgpack(path)
    return state_dict_from_flax(_numpy({k: restored[k] for k in
                                        ("params", "batch_stats")}))


def peek_epoch(path: str) -> int:
    """The epoch tag of a checkpoint. The resume path reads it first to
    rebuild the optimizer for the checkpoint's freeze stage (its groups
    differ across UNFIX_EPOCH) before loading the optimizer state."""
    if is_torch_file(path):
        return int(_load(path)["epoch"])
    return int(read_msgpack(path)["epoch"])


def _optax_momentum(opt_state, params):
    """optax's momentum of the staged optimizer
    (`usot_tpu/train/optim.py`: multi_transform over frozen / backbone /
    base, each trainable group `chain(add_decayed_weights, trace,
    scale)`) as one params-shaped tree: each leaf the `trace` of the
    group that holds it. A group's leaves it does not hold are optax's
    `MaskedNode`, which flax writes as an empty map; a leaf no group
    holds (frozen) gets zeros."""
    traces = []
    for label in ("backbone", "base"):
        chain = opt_state["inner_states"][label]["inner_state"]
        traces += [st["trace"] for st in chain.values()
                   if isinstance(st, dict) and "trace" in st]

    def merge(p, *ts):
        if isinstance(p, dict):
            return {k: merge(p[k], *(t[k] for t in ts)) for k in p}
        held = [t for t in ts if not isinstance(t, dict)]
        if len(held) > 1:
            raise ValueError("a parameter in two optimizer groups")
        return np.asarray(held[0], np.float32) if held \
            else np.zeros(np.shape(p), np.float32)

    return merge(params, *traces)


def _restore_flax(path: str, model, optimizer) -> int:
    """A `usot_tpu` training checkpoint into `model` and `optimizer`: the
    weights and BN stats, and optax's momentum trace as each trainable
    parameter's `momentum_buffer`. The port's optimizer holds only the
    trainable parameters, and every one of them gets a buffer, as the
    port's step leaves them (it zero-fills unreached gradients); the
    frozen ones, `MaskedNode` in optax, have no state in torch."""
    restored = _numpy(read_msgpack(path))
    variables = {k: restored[k] for k in ("params", "batch_stats")}
    model.load_state_dict(state_dict_from_flax(variables))
    momentum = state_dict_from_flax({
        "params": _optax_momentum(restored["opt_state"],
                                  variables["params"]),
        "batch_stats": variables["batch_stats"]})
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            buf = momentum[names[id(p)]].to(p.device, p.dtype)
            optimizer.state[p]["momentum_buffer"] = buf
    return int(restored["epoch"])


def restore_checkpoint(path: str, model, optimizer) -> int:
    """Load params, BN stats and the optimizer state (momentum buffers)
    in place, from the port's `.pth` or `usot_tpu`'s `.ckpt`; `optimizer`
    must be built for the checkpoint's stage. Returns the epoch."""
    if not is_torch_file(path):
        return _restore_flax(path, model, optimizer)
    state = _load(path)
    model.load_state_dict(state["state_dict"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
