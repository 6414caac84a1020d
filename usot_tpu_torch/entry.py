"""Entry points of the port: the flagship per-frame tracking forward, and
a data-parallel training step.

    python -m usot_tpu_torch.entry [--device cpu] [--multichip N]

Counterpart of `entry()` in the repo's `__graft_entry__.py`:
`entry(device=None) -> (fn, example_args)`, fn the per-frame forward of
the flagship USOT model at full width (width 64, channels 256, memory
queue 7): search features, then the offline and online heads, the
sigmoid applied to both score maps as in JAX. Seeded random weights
(`init_model`, seed 0). The args are in the port's public layout (NHWC,
as every public method of `USOTNet` takes them): the model, x (1, 255,
255, 3), zf (1, 7, 7, 256), mem (7, 7, 7, 256). On the card the three
GroupDW correlations go through the hand-written kernel (K1).

`dryrun_multichip(n_devices, device=None)`, the counterpart of the same
function of `__graft_entry__.py`: one cycle-memory step with the stages
unfrozen, over `n_devices` data-parallel ranks, on tiny geometry (template
63, search 95, an 11x11 search feature and a 5x5 score map, 2 memory
frames) at full width, with JAX's seeded batch of one row per rank.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from usot_tpu_torch.core.device import f32_numerics, resolve_device


def entry(device=None):
    """(fn, (model, x, zf, mem)) on `device` (default the GPU; raises
    without one unless device="cpu"); fn(model, x, zf, mem) -> (sigmoid
    cls, bbox, sigmoid cls_mem, xf)."""
    from usot_tpu_torch.models.usot import build_usot, init_model

    dev = resolve_device(device)
    f32_numerics()
    model = build_usot(mem_size=4, fused_xcorr=True)
    init_model(model, torch.Generator().manual_seed(0), device=dev)
    model.cast_weights()

    @torch.inference_mode()
    def fn(model, x, zf, mem):
        xf = model.search_features(x)
        cls, bbox, cls_mem = model.track_memory(xf, zf, mem)
        return torch.sigmoid(cls), bbox, torch.sigmoid(cls_mem), xf

    x = torch.zeros((1, 255, 255, 3), dtype=torch.float32, device=dev)
    zf = torch.zeros((1, 7, 7, 256), dtype=torch.float32, device=dev)
    mem = torch.zeros((7, 7, 7, 256), dtype=torch.float32, device=dev)
    return fn, (model, x, zf, mem)


def _dryrun_batch(b: int) -> dict:
    """`__graft_entry__.dryrun_multichip`'s batch, drawn in its order."""
    t, s, score, mem = 63, 95, 5, 2
    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    batch = {"template": arr(b, t, t, 3), "search": arr(b, s, s, 3)}
    batch["label"] = (rng.random((b, score, score)) > 0.8).astype(np.float32)
    batch["reg_target"] = np.abs(arr(b, score, score, 4)) + 1.0
    batch["reg_weight"] = (rng.random((b, score, score)) > 0.7).astype(
        np.float32)
    batch["template_bbox"] = np.asarray([[2.0, 2.0, 5.0, 5.0]] * b,
                                        np.float32)
    batch["search_memory"] = arr(b, mem, s, s, 3)
    batch["search_bbox"] = np.asarray([[3.0, 3.0, 8.0, 8.0]] * b,
                                      np.float32)
    return batch


def _dryrun_loss(n_rows: int, device, group=None) -> float:
    """The dry run's step on this rank's rows of its batch of `n_rows`
    (all of them without a group); returns the (global) loss."""
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.parallel.mesh import (broadcast_module, rank_rows,
                                              world_size)
    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    f32_numerics()
    model = build_usot(mem_size=2, search_size=95, sf_size=11)
    init_model(model, torch.Generator().manual_seed(0), device=device)
    rank = 0
    if group is not None:
        broadcast_module(model, group)
        rank = torch.distributed.get_rank(group)
    opt, _ = build_optimizer(model, 0.9, 1e-4, 0.1, True)
    step = make_train_step(model, opt, cycle_memory=True,
                           stage_bn_train=True, lambda_1=0.3, group=group)
    rows = rank_rows(n_rows, rank, world_size(group))
    batch = {k: torch.from_numpy(v[rows]).to(device)
             for k, v in _dryrun_batch(n_rows).items()}
    return float(step(batch, 0.005, 0.5)["loss"])


def _dryrun_rank(rank, world, group, device, out_path):
    loss = _dryrun_loss(world, device, group)
    if rank == 0:
        with open(out_path, "w") as f:
            f.write(repr(loss))


def dryrun_multichip(n_devices: int, device=None) -> float:
    """One data-parallel cycle-memory step over `n_devices` ranks; raises
    unless its loss is finite, and returns it. device None: the GPU,
    rank r on `cuda:r` over NCCL when that many cards are visible, else
    every rank on the first card over gloo (one card standing in for
    several); "cpu": gloo ranks on the CPU."""
    from usot_tpu_torch.parallel.mesh import file_rendezvous, launch

    dev = resolve_device(device)
    if device is None and torch.cuda.device_count() >= n_devices:
        devices, backend = [torch.device("cuda", i)
                            for i in range(n_devices)], "nccl"
    else:
        devices, backend = [dev] * n_devices, "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "loss")
        launch(_dryrun_rank, devices, backend, file_rendezvous(tmp),
               args=(out,))
        with open(out) as f:
            loss = float(f.read())
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite "
                           f"loss {loss}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} OK", flush=True)
    return loss


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="run entry() once, or "
                                 "dryrun_multichip(N)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--multichip", type=int, default=None,
                    help="run dryrun_multichip over N ranks instead")
    a = ap.parse_args(argv)
    if a.multichip:
        dryrun_multichip(a.multichip, a.device)
        return
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    sys.exit(main())
