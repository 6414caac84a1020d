"""Device mesh and process group: the counterpart of
`usot_tpu/parallel/mesh.py`.

JAX runs ONE program over a 1-D `data` mesh: the batch is sharded on
`data`, the parameters replicated, and XLA inserts whatever collectives
keep the program the single-device program on the global batch. The port
splits that in two:

* tracking (`BatchScanEngine(mesh=...)`): one process drives every device
  of a `Mesh`. The lanes split into contiguous blocks (`shard_batch`),
  each device gets a model replica (`replicate_tree`); the step needs no
  collective.
* training: one process per device (a rank), joined by a
  `torch.distributed` process group (`init_data_parallel`, `launch`).
  Rank r holds rows `rank_rows(G, r, W, k)` of each global batch of G
  rows; train-mode BatchNorm statistics and the losses' masked-mean
  counts are summed over the group with `all_reduce_sum` (which carries
  a gradient), and the gradients are averaged once per step
  (`train/step.py`), so the step computes what JAX's mesh step does.

A mesh device may repeat: `make_mesh(devices=["cuda:0", "cuda:0"])`
places two shards on one card, which is how one card stands in for two
(the same split, no scaling). Two training ranks can share a card over
gloo, which takes CUDA tensors; NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import copy
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D data mesh: one device per data shard (`devices`, repeats
    allowed) and `shape` {"data": n, "model": 1}."""

    def __init__(self, devices):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"data": len(self.devices), "model": 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A mesh over the first `n_data` of `devices` (default: every visible
    CUDA device; with none visible this raises: a mesh on the CPU is asked
    for with `devices=["cpu", "cpu", ...]`). A device may repeat. The
    model axis is 1, as at the reference's scale in JAX."""
    if n_model != 1:
        raise ValueError(f"n_model={n_model}: only a 1-D data mesh "
                         "(n_model=1) is supported")
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices="
                               "['cpu', ...] for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    n_data = len(devices) if n_data is None else n_data
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"n_data={n_data} for {len(devices)} devices")
    return Mesh(devices[:n_data])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """The lane blocks of `P("data")`: a list of `mesh.size` trees, the
    i-th holding rows [i B/n, (i+1) B/n) of every array or tensor of
    `batch` (leading dim B) as a tensor on `mesh.devices[i]`."""
    n = mesh.size

    def block(x, i):
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"leading dim {t.shape[0]} does not divide "
                             f"by the mesh's {n} devices")
        s = t.shape[0] // n
        return t[i * s:(i + 1) * s].to(mesh.devices[i])

    return [_tree_map(lambda x, i=i: block(x, i), batch) for i in range(n)]


def _place(tree, device):
    if isinstance(tree, torch.nn.Module):
        p = next(tree.parameters(), None)
        if p is not None and p.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    return _tree_map(lambda t: torch.as_tensor(t).to(device), tree)


def replicate_tree(mesh: Mesh, tree):
    """One copy of `tree` (a module, or a tree of tensors) per distinct
    device of the mesh. Returns a list aligned with `mesh.devices`:
    devices that repeat share one copy, and a module already on a mesh
    device is used there as it is."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = _place(tree, d)
    return [copies[d] for d in mesh.devices]


# ------------------------------------------------------- process group

def init_data_parallel(rank: int, world: int, backend: str,
                       init_method: str, timeout_s: float = 300.0):
    """Join the process group as rank `rank` of `world` over `backend`
    ("nccl" across cards, "gloo" on the CPU or for ranks that share a
    card), meeting at `init_method` (`tcp://localhost:<port>` or
    `file://<path>`). Returns the group. Raises when the group cannot be
    formed; nothing continues without it."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def file_rendezvous(directory: str) -> str:
    """A fresh `file://` rendezvous under `directory` (made if needed):
    the path must not exist before the group forms."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory),
                        f".rendezvous_{os.getpid()}_{time.time_ns()}")
    return "file://" + path


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def is_main() -> bool:
    """True in rank 0, and in a process that joined no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_module(module: torch.nn.Module, group, src: int = 0):
    """Every parameter and buffer of `module` set to rank `src`'s, in
    place."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src, group=group)


def rank_rows(global_batch: int, rank: int, world: int,
              accum: int = 1) -> np.ndarray:
    """Rank `rank`'s rows of a global batch of `global_batch` rows under
    `accum` microbatches: for each microbatch i, rows i G/k + r G/(kW) + j,
    j < G/(kW). The rank's local batch then splits contiguously into its
    share of each of JAX's microbatches (`usot_tpu/train/step.py:127-131`
    takes contiguous G/k rows); at k = 1 it is the contiguous block
    `P("data")` gives. Raises unless G divides by k W, as JAX asserts."""
    if global_batch % (accum * world):
        raise ValueError(f"global batch {global_batch} does not divide by "
                         f"accum {accum} x world {world}")
    per = global_batch // (accum * world)
    micro = global_batch // accum
    return np.array([i * micro + rank * per + j for i in range(accum)
                     for j in range(per)], np.int64)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward; the gradient summed over the group
    backward (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the process group `group`, with a gradient: every
    rank must call it, in the same order, forward and backward."""
    return _AllReduceSum.apply(x, group)


# ------------------------------------------------------------- launcher

def _rank_main(rank, fn, devices, backend, init_method, threads, args):
    if threads:
        torch.set_num_threads(threads)
    device = _device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = init_data_parallel(rank, len(devices), backend, init_method)
    try:
        fn(rank, len(devices), group, device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, devices, backend: str, init_method: str, args=(),
           threads: int | None = None):
    """Run `fn(rank, world, group, device, *args)` as ranks 0..W-1 of a
    process group over `backend`, rank r on `devices[r]` (W =
    len(devices); devices may repeat). With W > 1 each rank is a process
    of torch.multiprocessing's `spawn` context (CUDA forbids `fork`), `fn`
    and `args` pickled to it (`fn` a module-level function, so children
    import its module and not the caller's), with `threads` torch threads
    (default: this process's count shared out, at least 1). Returns when
    every rank has returned; if one raises, the others are terminated and
    this raises. With W = 1 the rank runs in this process."""
    world = len(devices)
    if world == 1:
        _rank_main(0, fn, devices, backend, init_method, None, args)
        return
    threads = threads or max(1, torch.get_num_threads() // world)
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, [str(d) for d in devices], backend,
                          init_method, threads, args),
        nprocs=world, join=True, start_method="spawn")
