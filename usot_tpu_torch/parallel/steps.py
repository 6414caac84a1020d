"""Data-parallel training steps run case by case, to hold them against the
one-process step on the global batch.

A job (a dict, saved with `torch.save` so that spawned ranks load it from
a file) holds the model's keyword arguments (`build_usot`), its initial
state dict and a list of cases. Each case is one of:

* a training step: {"name", "kind": "step", "cycle", "unfix", "accum",
  "sync_bn", "dtype" ("float32" | "float64"), "batch" (the GLOBAL batch,
  numpy, shard layout), "nan_rank" (a rank whose images are made NaN, or
  None), "timed" (extra steps timed after the checked one)}. A step
  records its global losses, the BN running stats, a digest of its
  parameters, buffers and gradients, and, unless the job says
  "full": False (at full width they are ~1.4 GB a rank), the whole
  state dict and the gradients; rank 0 records its gradients always;
* a BatchNorm probe: {"name", "kind": "bn", "x" (global (G, C, H, W)),
  "weight", "bias", "upstream" (global, the loss is sum(y * upstream))},
  in x's dtype;
* a masked mean: {"name", "kind": "masked_mean", "values", "mask"}
  (global (G, N)).

`step_rank` is the rank function of `parallel.mesh.launch`: every rank
runs every case on its rows of the global batch (`rank_rows`) and writes
what it saw to `<out>/rank<r>.pt`, with the kernel launches it made.
`one_process` runs the same cases on the global batch in one process.
The tests hold both against JAX's mesh step; `chip_smoke.py` holds two
ranks on one card against one process on it.
"""
from __future__ import annotations

import hashlib
import os
import statistics
import time

import numpy as np
import torch

from usot_tpu_torch.core.device import f32_numerics
from usot_tpu_torch.models.layers import BatchNorm
from usot_tpu_torch.parallel.mesh import rank_rows, world_size
from usot_tpu_torch.train.losses import _masked_mean

# the recipe's step constants, as the training tests use them
LR, CLS_RATIO, LAMBDA_1 = 0.005, 0.5, 0.3
MOMENTUM, WEIGHT_DECAY, LAYERS_LR = 0.9, 1e-4, 0.1


def _numpy(t):
    return t.detach().cpu().numpy().copy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def _step_case(model, state, case, rows, group, device, full, rank):
    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import images_f32, make_train_step

    dtype = getattr(torch, case["dtype"])
    model.load_state_dict(state)
    model.to(device, dtype)
    model.zero_grad(set_to_none=True)  # no gradient of an earlier case
    opt, _ = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR,
                             case["unfix"])
    step = make_train_step(model, opt, case["cycle"], case["unfix"],
                           LAMBDA_1, accum_steps=case["accum"], group=group,
                           sync_bn=case["sync_bn"])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
             for k, v in case["batch"].items()}
    if case.get("nan_rank") is not None and group is not None \
            and torch.distributed.get_rank(group) == case["nan_rank"]:
        batch["search"] = torch.full(images_f32(batch["search"]).shape,
                                     float("nan"), device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    met = step(batch, LR, CLS_RATIO)
    _sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    sd = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    out = {"metrics": {k: float(v) for k, v in met.items()},
           "stats": {k: _numpy(t) for k, t in sd.items()
                     if k.endswith(("running_mean", "running_var"))},
           "digest": _digest([*sd.values(), *grads.values()]),
           "first_ms": first_ms}
    if full:
        out["state"] = {k: _numpy(t) for k, t in sd.items()}
    if full or rank == 0:
        out["grads"] = {n: _numpy(g) for n, g in grads.items()}
    ms = []
    for _ in range(case.get("timed", 0)):
        _sync(device)
        t0 = time.perf_counter()
        step(batch, LR, CLS_RATIO)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["ms_per_step"] = statistics.median(ms) if ms else None
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    return out


def _bn_case(case, rows, group, device):
    x = torch.from_numpy(case["x"][rows]).to(device).requires_grad_(True)
    bn = BatchNorm(x.shape[1]).to(device, x.dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    bn.group = group
    y = bn(x, train=True)
    (y * torch.from_numpy(case["upstream"][rows]).to(device)).sum() \
        .backward()
    return {"y": _numpy(y), "x_grad": _numpy(x.grad),
            "weight_grad": _numpy(bn.weight.grad),
            "bias_grad": _numpy(bn.bias.grad),
            "running_mean": _numpy(bn.running_mean),
            "running_var": _numpy(bn.running_var)}


def _masked_mean_case(case, rows, group, device):
    values = torch.from_numpy(case["values"][rows]).to(device) \
        .requires_grad_(True)
    mask = torch.from_numpy(case["mask"][rows]).to(device)
    out = _masked_mean(values, mask, group)
    out.backward()
    return {"value": float(out), "values_grad": _numpy(values.grad)}


def run_cases(job: dict, device, group=None, rank: int = 0) -> dict:
    """Every case of `job` on this rank's rows (all rows without a
    group). Returns {case name: result}."""
    from usot_tpu_torch.models.usot import build_usot

    world = world_size(group)
    f32_numerics()
    model = None
    results = {}
    for case in job["cases"]:
        kind = case["kind"]
        global_batch = len(next(iter(case["batch"].values()))) \
            if kind == "step" else len(case["x" if kind == "bn"
                                            else "values"])
        rows = rank_rows(global_batch, rank, world, case.get("accum", 1))
        if kind == "step":
            if model is None:
                model = build_usot(**job["model"])
            results[case["name"]] = _step_case(
                model, job["state"], case, rows, group, device,
                job.get("full", True), rank)
        elif kind == "bn":
            results[case["name"]] = _bn_case(case, rows, group, device)
        else:
            results[case["name"]] = _masked_mean_case(case, rows, group,
                                                      device)
    return results


def step_rank(rank, world, group, device, job_path, out_dir):
    """Rank function for `parallel.mesh.launch`: the job at `job_path`
    on this rank's rows; results to `<out_dir>/rank<rank>.pt`, with the
    rank's seconds to load the job and to run the cases, and the wall
    clock (`time.time()`) where it started and before it saved, under
    "_seconds", and the kernel launches this rank made while it ran the
    cases (`ops.xcorr_kernel.launch_counts`), under "_launches"."""
    from usot_tpu_torch.ops.xcorr_kernel import launch_counts, \
        reset_launch_counts

    start, t0 = time.time(), time.perf_counter()
    job = torch.load(job_path, weights_only=False)
    t1 = time.perf_counter()
    reset_launch_counts()
    results = run_cases(job, device, group, rank)
    results["_launches"] = launch_counts()
    results["_seconds"] = {"start": start, "load": t1 - t0,
                           "cases": time.perf_counter() - t1,
                           "end": time.time()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def one_process(job: dict, device) -> dict:
    """The job's cases in this process on the global batch."""
    return run_cases(job, torch.device(device))


def run_ranks(job: dict, devices, backend: str, work_dir: str) -> list:
    """The job over len(devices) ranks (`parallel.mesh.launch`, meeting
    at a `file://` rendezvous under `work_dir`). Returns each rank's
    results, in rank order."""
    from usot_tpu_torch.parallel.mesh import file_rendezvous, launch

    os.makedirs(work_dir, exist_ok=True)
    job_path = os.path.join(work_dir, "job.pt")
    torch.save(job, job_path)
    launch(step_rank, devices, backend, file_rendezvous(work_dir),
           args=(job_path, work_dir))
    return [torch.load(os.path.join(work_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(devices))]
