"""What one stage of the frame step costs on the card: device and eager
time, operations, bytes and the roofline bound. Shared by the step
attribution tools (`microbench_step`, `cliff_sweep`, `cliff_bisect`).

* Time (`stage_times`): `timing.time_device_ms`, a CUDA graph of `inner`
  calls replayed between CUDA events (the counterpart of a stage timed
  inside JAX's `jit(lax.scan(...))`), and `timing.time_call_ms`, the
  eager call with the host's launches. On the CPU neither is a device
  figure: `device_ms` is None ("not measured") and `call_ms` the host's
  wall time of one call.
* Operations (`stage_counts`): `FlopCounterMode` counts the aten ops
  (convolutions, matmuls); the correlation kernels are ctypes calls it
  cannot see, so their analytic counts come from
  `ops.xcorr.CALL_LISTENERS` (K1: 2*B*M*C*Ho*Wo*55), as JAX adds
  `GROUPDW_FLOPS` for its Pallas kernel.
* Bytes (`TrafficMode`, a `TorchDispatchMode`): the stage's bound counts
  each tensor it reads from outside (inputs and parameters) once and
  each tensor it writes (its outputs, its in-place writes) once; an
  index op (`index_select`,
  `gather`, `index_copy_`, `index_put_`) moves the rows it selects, not
  the tensor it indexes. Beside it, the op-level traffic: every aten
  op's input and output bytes, views (outputs that alias an input)
  excluded, the counterpart of XLA's "bytes accessed".
* Roofline (`roofline`): the larger of operations over the peak of the
  compute dtype (989 TFLOP/s bf16 on the tensor cores; 67 TFLOP/s f32
  outside them, TF32 off) and bytes over 3.35 TB/s of HBM, labelled
  "tensor", "fp32" or "HBM"; its share is bound / device time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from usot_tpu_torch.ops import xcorr
from usot_tpu_torch.ops.xcorr_kernel import launch_counts

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# H100 SXM data sheet, dense; the card's power limit is printed beside
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BOUND_LABEL = {"bf16": "tensor", "f32": "fp32"}

# ops that read or write only the rows they index
_GATHERS = {"index_select", "gather"}
_SCATTERS = {"index_copy_", "index_put_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


class TrafficMode(TorchDispatchMode):
    """Counts the bytes of the aten ops run inside it (see the module
    note). After the block: `op_bytes`, `external` ({(address, bytes):
    bytes} of what was read from tensors made outside), `inplace_bytes`
    (written into tensors made outside) and `produced` (the storages of
    the tensors made inside). A correlation call (`kernel_call`, an
    `ops.xcorr` listener) counts its inputs read and its output written
    once, and none of the ops inside it (the plain version's)."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0
        self.external = {}
        self.inplace_bytes = 0
        self.produced = set()
        self._quiet = 0

    def _read(self, t, nbytes):
        self.op_bytes += nbytes
        if _storage(t) not in self.produced:
            self.external[(t.data_ptr(), nbytes)] = nbytes

    @contextlib.contextmanager
    def kernel_call(self, tag, flops, inputs, out_bytes):
        if not self._quiet:
            for t in inputs:
                self._read(t, _nbytes(t))
            self.op_bytes += out_bytes
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        aliased = {_storage(t) for t in ins}
        inplace = name.endswith("_")
        if not inplace and outs and all(_storage(o) in aliased for o in outs):
            return out          # a view (`to` that did not convert too)
        if self._quiet:
            if not inplace:
                self.produced.update(_storage(o) for o in outs)
            return out
        if name in _GATHERS and outs:
            # the source is read only where the index points
            self._read(ins[0], sum(_nbytes(o) for o in outs))
            for t in ins[1:]:
                self._read(t, _nbytes(t))
        elif name in _SCATTERS:
            # self is written where the index points, not read
            src = ins[1:]
            for t in src:
                self._read(t, _nbytes(t))
            written = _nbytes(src[-1]) if src else 0
            self.op_bytes += written
            if _storage(ins[0]) not in self.produced:
                self.inplace_bytes += written
            return out
        else:
            for t in ins:
                self._read(t, _nbytes(t))
        for o in outs:
            self.op_bytes += _nbytes(o)
            if inplace and ins and _storage(o) == _storage(ins[0]):
                if _storage(o) not in self.produced:
                    self.inplace_bytes += _nbytes(o)
            else:
                self.produced.add(_storage(o))
        return out


def _tensors(result):
    return [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]


def stage_counts(fn) -> dict:
    """One call of `fn` under the counters, after one warm call (which
    makes the casts of weights the model keeps, `models.layers.derived`).
    Returns its aten and kernel
    operations, the bytes of its bound (`min_bytes`: external reads,
    outputs made inside, in-place writes) and of its ops (`op_bytes`),
    the correlation kernels' calls by tag (`kernel_calls`, any device)
    and launches (`launches`, the wrappers' counters: CUDA only)."""
    kernel_flops, calls = [0.0], {}
    traffic = TrafficMode()

    @contextlib.contextmanager
    def heard(tag, flops, inputs, out_bytes):
        kernel_flops[0] += flops
        calls[tag] = calls.get(tag, 0) + 1
        with traffic.kernel_call(tag, flops, inputs, out_bytes):
            yield

    fn()
    before = launch_counts()
    xcorr.CALL_LISTENERS.append(heard)
    try:
        with FlopCounterMode(display=False) as counter, traffic:
            result = fn()
    finally:
        xcorr.CALL_LISTENERS.remove(heard)
    after = launch_counts()
    made = [t for t in _tensors(result) if _storage(t) in traffic.produced]
    outputs = sum(_nbytes(t) for t in made)
    return {"aten_flops": float(counter.get_total_flops()),
            "kernel_flops": kernel_flops[0],
            "min_bytes": float(sum(traffic.external.values()) + outputs
                               + traffic.inplace_bytes),
            "out_bytes": float(outputs),
            "op_bytes": float(traffic.op_bytes),
            "kernel_calls": calls,
            "launches": {k: after[k] - before[k] for k in after},
            # storages of what `fn` returns without making it: its inputs
            # passed through or written in place (the rings)
            "passthrough": {_storage(t) for t in _tensors(result)
                            if _storage(t) not in traffic.produced}}


def roofline(flops: float, nbytes: float, ms, dtype: str) -> dict:
    """Bound of `flops` operations and `nbytes` bytes on one H100 in
    `dtype` ("bf16" or "f32"): its ms, what bounds it ("tensor", "fp32"
    or "HBM") and, with a device time `ms`, the achieved rates and the
    share bound / ms (None without one)."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    rec = {"bound_ms": bound_ms,
           "bound": BOUND_LABEL[dtype] if t_ops >= t_bytes else "HBM",
           "tflops": None, "gbps": None, "share_pct": None}
    if ms:
        rec.update(tflops=flops / (ms * 1e-3) / 1e12,
                   gbps=nbytes / (ms * 1e-3) / 1e9,
                   share_pct=100.0 * bound_ms / ms)
    return rec


def stage_times(fn, device, iters: int, reps: int = 5) -> dict:
    """`device_ms` (CUDA graph of `iters` calls, median of `reps`
    replays; None on the CPU) and `call_ms` (an eager call; on the CPU
    the host's wall time, median of `reps`)."""
    if device.type == "cuda":
        from usot_tpu_torch.tools.timing import time_call_ms, time_device_ms

        return {"device_ms": time_device_ms(fn, inner=iters, reps=reps),
                "call_ms": time_call_ms(fn, reps=reps)}
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"device_ms": None, "call_ms": float(np.median(times))}


def events_ms(fn, device, reps: int = 3) -> float | None:
    """Min over `reps` of one eager call between CUDA events (a chunk,
    whose loop holds host work); None on the CPU."""
    if device.type != "cuda":
        fn()
        return None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def measure(name: str, fn, device, dtype: str, iters: int,
            batch: int) -> dict:
    """A stage's record: `stage_counts` of `fn` (which returns the
    stage's outputs), `stage_times` of `fn` ending in `readout`,
    `roofline`, and per sample (`batch`) its operations and bytes."""
    counts = stage_counts(fn)
    skip = counts.pop("passthrough")
    times = stage_times(lambda: readout(fn(), skip), device, iters)
    flops = counts["aten_flops"] + counts["kernel_flops"]
    rec = {"stage": name, **times, **counts, "gflop": flops / 1e9,
           "min_mb": counts["min_bytes"] / 1e6,
           "op_mb": counts["op_bytes"] / 1e6,
           "mflop_per_sample": flops / batch / 1e6,
           "min_kb_per_sample": counts["min_bytes"] / batch / 1e3,
           "op_kb_per_sample": counts["op_bytes"] / batch / 1e3}
    rec.update(roofline(flops, counts["min_bytes"], times["device_ms"],
                        dtype))
    return rec


def readout(result, skip=()):
    """The sum of the full-tensor means of a stage's outputs, in f32: a
    sliced readout would let XLA drop work in JAX's tools
    (`tools/cliff_sweep.py:9-16`), so both packages read every output
    element the stage makes. Tensors whose storage is in `skip` (inputs
    passed through, rings written in place) are not read again."""
    tensors = [t for t in _tensors(result)
               if t.is_floating_point() and _storage(t) not in skip]
    return sum(t.float().mean() for t in tensors)


def common_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The arguments every step tool takes besides the JAX tool's own."""
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                    "one). `cpu` runs on the CPU")
    ap.add_argument("--json", default=None,
                    help="write the tool's record to this path")
    ap.add_argument("--ckpt", default=os.environ.get("BENCH_CKPT"),
                    help="weights (default BENCH_CKPT; else "
                    "`tools.bench.load_weights`' order)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    return ap


def open_device(args):
    """(device, card line) for a tool's arguments: the GPU unless
    `--device cpu`; raises without one. TF32 off."""
    from usot_tpu_torch.core.device import f32_numerics, resolve_device

    device = resolve_device(args.device)
    f32_numerics()
    card = "cpu"
    if device.type == "cuda":
        from usot_tpu_torch.tools.timing import card_line

        card = card_line()
    print(f"{card}; device {device}", flush=True)
    return device, card


def load_model(args, device, dtype, weights=None, fused_xcorr=True):
    """The model of `args.width`/`args.channels` in the compute `dtype`
    ("bf16" or "f32") on `device`, holding `weights` (a state dict), else
    `tools.bench.load_weights(args.ckpt)`: `BENCH_CKPT`, the full
    schedule's `checkpoint_e30.pth`, or the cached calibrated random
    weights. `build_usot(mem_size=4)`, as the JAX tools build it;
    `fused_xcorr` sends the pair correlations to K1 too."""
    from usot_tpu_torch.models.usot import build_usot

    if weights is None:
        from usot_tpu_torch.tools.bench import load_weights

        weights = load_weights(args.ckpt, device)[0]
    model = build_usot(mem_size=4, width=args.width, channels=args.channels,
                       fused_xcorr=fused_xcorr, dtype=DTYPES[dtype])
    model.load_state_dict(weights)
    return model.to(device).eval().cast_weights()


def fmt(v, spec=".4f") -> str:
    """A measured number, or "not measured" where there is none."""
    return "not measured" if v is None else format(v, spec)


def write_json(path, rec):
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
