#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`usot_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the hand-written GroupDW kernel, compiled by nvcc for sm_90a
     from `usot_tpu_torch/ops/csrc/xcorr_groupdw.cu`;
  3. kernel check: the kernel against its plain PyTorch version at the
     tracker's four production shapes ({255, 271} x M in {1, 7}, B=1,
     C=256, f32), a ragged shape and bf16, with its time, the plain
     version's, a grouped-conv library call's and the bound;
  4. slice: USOT* tracking at full width (width 64, channels 256, memory
     queue 7), random seeded weights with calibrated BN stats, two
     synthetic 480x640 videos (instance 255 and 271) through
     `USOTTracker` + `ModelRunner`; the network's outputs are checked
     against the same model on the CPU, and the kernel must have been
     launched exactly 3 times per tracked frame.
The last line is {"ok": true, "device": {...}}. Without CUDA the script
exits with an error and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# The parity and crop numerics are f32: cuDNN convolutions default to
# TF32 on Ampere and later, which keeps ~3 decimal digits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# H100 SXM data sheet (dense): HBM3 bandwidth, FP32 rate without tensor
# cores. The kernel's FMAs run on the FP32 units for f32 and bf16 input.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TAPS = 5 * 5 + 3 * 5 + 5 * 3
SOURCE = "usot_tpu_torch/ops/csrc/xcorr_groupdw.cu"
REPLACES = "usot_tpu/ops/pallas/xcorr_kernel.py:135"
TPU_KERNEL = "usot_tpu/ops/pallas/xcorr_kernel.py::xcorr_groupdw_pallas"
OUT_DIR = "chiprun_out"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

def time_device_ms(fn, inner: int = 10, reps: int = 50) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph,
    the graph replayed `reps` times between CUDA events; the median
    replay divided by `inner`. Host launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_call_ms(fn, reps: int = 50) -> float:
    """Wall time of one eager call, host launch cost included (median of
    `reps`, each ended by a synchronize)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ------------------------------------------------------------ kernel check

def groupdw_inputs(rng, b, m, c, hx, wx, dtype, device):
    """Three scales (5x5, 3x5, 5x3 kernels) meeting at one Ho x Wo."""
    x_shapes = [(b, hx, wx, c), (b, hx - 2, wx, c), (b, hx, wx - 2, c)]
    k_shapes = [(b, m, 5, 5, c), (b, m, 3, 5, c), (b, m, 5, 3, c)]
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          .to(device=device, dtype=dtype) for s in x_shapes]
    ks = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          .to(device=device, dtype=dtype) for s in k_shapes]
    return xs, ks


def groupdw_library(xs, ks):
    """The same function as three grouped convolutions (one group per
    (b, c), M outputs each) and two adds: the reference's grouped-conv
    formulation (ref: lib/models/connect.py:147-157) without the repeat
    of the search map. A yardstick only; the port never calls it.
    Returns a function of no arguments over inputs laid out for cuDNN."""
    b, m, c = ks[0].shape[0], ks[0].shape[1], ks[0].shape[4]
    x_nchw = [x.permute(0, 3, 1, 2).reshape(1, b * c, *x.shape[1:3])
              .contiguous() for x in xs]
    w_oihw = [k.permute(0, 4, 1, 2, 3).reshape(b * c * m, 1, *k.shape[2:4])
              .contiguous() for k in ks]

    def run():
        out = F.conv2d(x_nchw[0], w_oihw[0], groups=b * c)
        out = out + F.conv2d(x_nchw[1], w_oihw[1], groups=b * c)
        return out + F.conv2d(x_nchw[2], w_oihw[2], groups=b * c)

    def to_bmhwc(out):
        ho, wo = out.shape[2], out.shape[3]
        return out.reshape(b, c, m, ho, wo).permute(0, 2, 3, 4, 1)

    return run, to_bmhwc


def bound(xs, ks, out):
    """Least time for the work on an H100 SXM: each input read once and
    the output written once at the HBM rate, against the FMAs at the
    FP32 rate. Returns (ms, 'bytes' | 'operations')."""
    nbytes = sum(t.numel() * t.element_size() for t in (*xs, *ks, out))
    flops = 2.0 * out.numel() * TAPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_checks(kernel, reference, device, c=256, timed=True):
    """Holds `kernel` against `reference` on the production shapes, a
    ragged one and bf16. Returns per-shape records."""
    rng = np.random.default_rng(0)
    cases = []
    for inst, s in ((255, 31), (271, 33)):
        for m in (1, 7):
            cases.append((f"instance {inst}, B=1, M={m}, C={c}, f32",
                          (1, m, c, s - 2, s - 2), torch.float32))
    cases.append(("ragged B=3, M=5, C=96, f32", (3, 5, 96, 11, 13),
                  torch.float32))
    cases.append((f"instance 255, B=1, M=7, C={c}, bf16",
                  (1, 7, c, 29, 29), torch.bfloat16))
    records = []
    for label, (b, m, cc, hx, wx), dtype in cases:
        xs, ks = groupdw_inputs(rng, b, m, cc, hx, wx, dtype, device)
        out = kernel(xs, ks)
        if dtype == torch.float32:
            ref = reference(xs, ks)
            # Pallas kernel's tolerance (tests/test_ops.py:260), scale-aware
            tol = 1e-4 * max(float(ref.abs().max()), 1.0)
        else:
            # plain version on the same bf16 inputs in f32; the kernel
            # rounds its f32 sum to bf16 once (unit roundoff 2^-8), so
            # 2^-7 of the largest output leaves room for the f32
            # summation order
            ref = reference([x.float() for x in xs], [k.float() for k in ks])
            tol = 2.0 ** -7 * max(float(ref.abs().max()), 1.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype,
              f"GroupDW kernel {label}: shape/dtype {tuple(out.shape)} "
              f"{out.dtype}")
        err = float((out.float() - ref.float()).abs().max())
        check(err <= tol, f"GroupDW kernel {label}: max |err| {err} > {tol}")
        rec = {"shape": label, "x": [list(x.shape) for x in xs],
               "k": [list(k.shape) for k in ks], "out": list(out.shape),
               "max_abs_err": err, "tol": tol}
        rec["bound_ms"], rec["bound_by"] = bound(xs, ks, out)
        if dtype == torch.float32 and b == 1:
            lib_run, to_bmhwc = groupdw_library(xs, ks)
            lib_err = float((to_bmhwc(lib_run()) - ref).abs().max())
            check(lib_err <= tol, f"grouped-conv yardstick {label}: "
                  f"max |err| {lib_err} > {tol}")
            if timed:
                rec["ms"] = time_device_ms(lambda: kernel(xs, ks))
                rec["call_ms"] = time_call_ms(lambda: kernel(xs, ks))
                rec["plain_ms"] = time_device_ms(lambda: reference(xs, ks),
                                                 inner=2, reps=20)
                rec["library_ms"] = time_device_ms(lib_run)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


# ------------------------------------------------------------------ slice

def synthetic_video(n_frames, box, h=480, w=640, seed=0):
    """The recipe of tests/test_tracker.py:11-23 on a 480x640 canvas:
    a moving coloured square on uniform noise."""
    rng = np.random.default_rng(seed)
    frames, centers = [], []
    for f in range(n_frames):
        im = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cx, cy = 100 + 6 * f, 120 + 3 * f
        im[cy - box // 2: cy + box // 2, cx - box // 2: cx + box // 2] = [
            200, 180, 60]
        frames.append(im)
        centers.append((cx, cy))
    return frames, centers


def close_scaled(a, b, tol):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = max(float(b.abs().max()), 1.0)
    return float((a - b).abs().max()) / scale <= tol, \
        float((a - b).abs().max()) / scale


def run_slice(device, width=64, channels=256, n_frames=21, n_iter=10,
              card=""):
    from usot_tpu_torch.models.calibrate import calibrate_batch_stats
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.ops.xcorr_kernel import xcorr_groupdw_cuda
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.tracker.tracker import USOTTracker

    t0 = time.perf_counter()
    model = build_usot(mem_size=7, width=width, channels=channels,
                       fused_xcorr=True)
    init_model(model, torch.Generator().manual_seed(0), device=device)
    calibrate_batch_stats(model, n_iter=n_iter)
    runner = ModelRunner(model, device=device)
    setup_s = time.perf_counter() - t0
    print(f"slice: width {width}, channels {channels}, model built and "
          f"calibrated ({n_iter} passes) in {setup_s:.2f} s", flush=True)

    videos = [("instance 255, 48-px box", 48, 255),
              ("instance 271, 16-px box", 16, 271)]
    xcorr_groupdw_cuda.launches = 0  # the main path starts here
    results, tracked = [], 0
    for label, box, inst in videos:
        frames, centers = synthetic_video(n_frames, box)
        tracker = USOTTracker()
        before = xcorr_groupdw_cuda.launches
        st = tracker.init(frames[0], np.array(centers[0], np.float64),
                          np.array([box, box], np.float64), runner)
        check(st["p"].instance_size == inst,
              f"{label}: instance size {st['p'].instance_size}")
        frame_ms = []
        for im in frames[1:]:
            t1 = time.perf_counter()
            st = tracker.track(st, im)  # ends in device-to-host copies
            frame_ms.append((time.perf_counter() - t1) * 1e3)
            check(np.all(np.isfinite(st["target_pos"])),
                  f"{label}: position {st['target_pos']}")
            check(np.all(np.isfinite(st["target_sz"]))
                  and np.all(st["target_sz"] >= 10),
                  f"{label}: size {st['target_sz']}")
        n = len(frames) - 1
        tracked += n
        check(len(st["memory_features"]) == n + 1
              and len(st["memory_confidences"]) == n + 1,
              f"{label}: memory queue length {len(st['memory_features'])}")
        check(tuple(st["memory_features"][-1].shape) == (1, 7, 7, channels),
              f"{label}: memory feature {st['memory_features'][-1].shape}")
        launches = xcorr_groupdw_cuda.launches - before
        median = statistics.median(frame_ms)
        rec = {"video": label, "frames_tracked": n, "kernel_launches": launches,
               "ms_per_frame_median": median, "fps": 1e3 / median,
               "ms_per_frame_min": min(frame_ms),
               "final_pos": [float(v) for v in st["target_pos"]],
               "card": card}
        print(json.dumps(rec), flush=True)
        if device.type == "cuda":
            check(launches == 3 * n, f"{label}: {launches} GroupDW kernel "
                  f"launches for {n} tracked frames, expected {3 * n}")
        results.append((rec, st))
    total = xcorr_groupdw_cuda.launches  # read just after the main path
    if device.type == "cuda":
        check(total == 3 * tracked,
              f"{total} kernel launches for {tracked} tracked frames")
    return model, results, total


def parity_vs_cpu(model, results, device):
    """The network on the card against the same model on the CPU (plain
    correlation, CPU convolutions) on one crop of the slice: search
    features at 1e-3, head outputs at 1e-3, scale-aware. The margin over
    1e-4 covers cuDNN's and the CPU's different f32 summation orders
    through ~50 convolutions with random weights."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((1, 255, 255, 3)) * 255)
                         .astype(np.float32))
    cpu_model = copy.deepcopy(model).cpu().eval()
    _, st = results[0]
    zf = st["zf"]
    mem = torch.cat(st["init_features"] + st["memory_features"][-5:], dim=0)
    errs = {}
    with torch.inference_mode():
        xf_dev = model.search_features(x.to(device))
        xf_cpu = cpu_model.search_features(x)
        ok, errs["search_features"] = close_scaled(xf_dev, xf_cpu, 1e-3)
        check(ok, f"search features GPU vs CPU: {errs['search_features']}")
        out_dev = model.track_memory(xf_dev, zf, mem)
        out_cpu = cpu_model.track_memory(xf_dev.cpu(), zf.cpu(), mem.cpu())
        for name, a, b in zip(("cls", "bbox", "cls_mem"), out_dev, out_cpu):
            check(bool(torch.isfinite(a).all()), f"{name} not finite")
            ok, errs[name] = close_scaled(a, b, 1e-3)
            check(ok, f"{name} GPU vs CPU: {errs[name]}")
    print(json.dumps({"gpu_vs_cpu_scaled_max_err": errs}), flush=True)
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from usot_tpu_torch.ops import xcorr_kernel
    from usot_tpu_torch.ops.xcorr import xcorr_groupdw_reference

    t_start = time.perf_counter()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    lib, log = xcorr_kernel.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    records = kernel_checks(xcorr_kernel.xcorr_groupdw_cuda,
                            xcorr_groupdw_reference, device)
    model, results, launches = run_slice(device, card=card)
    errs = parity_vs_cpu(model, results, device)

    head = records[1]  # instance 255, M=7: the memory head's launch
    kernels = [{
        "name": "xcorr_groupdw", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "tpu_kernel": TPU_KERNEL,
        "launches": launches, "launches_per_frame": 3,
        "shape": head["shape"],
        "max_abs_err": head["max_abs_err"], "max_err": head["max_abs_err"],
        "ms": head["ms"], "call_ms": head["call_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shapes": records,
    }]
    summary = {"card": card, "kind": kind, "kernels": kernels,
               "slice": [r for r, _ in results], "gpu_vs_cpu": errs,
               "seconds": time.perf_counter() - t_start}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"total {summary['seconds']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
