#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`usot_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the hand-written correlation kernels, one nvcc per source,
     all started together, for sm_90a: K1 from
     `usot_tpu_torch/ops/csrc/xcorr_groupdw.cu`, K2 and K3 from
     `usot_tpu_torch/ops/csrc/xcorr_depthwise.cu`, both over the tiled
     routine of `xcorr_tile.cuh`; each instantiation's `-Xptxas -v`
     registers and spills, failing on any spill;
  3. K1 check: the kernel against its plain PyTorch version at the
     parity tracker's four shapes ({255, 271} x M in {1, 7}, B=1), the
     batch engine's two (B=32, instance 255, M in {1, 7}), C=256, f32, a
     ragged shape, bf16 and the tiled kernel's edges (C=40, odd C, M=5,
     Ho 13/27, Wo 27/33/40), with its time, the plain version's, a
     grouped-conv library call's and the bound;
  4. K2/K3 checks: the same for the single-scale kernels, at their
     tools' shapes (K3 B=32 and B=224, K2 B=32 with M=7; 29x29 search,
     5x5 kernel, C=256) in f32 and bf16, the three shapes of
     `tests/test_ops.py:225-227`, a ragged one (B=3, C=96, odd Wo) and
     the same edges, B=1 at M=1 and 7 among them;
  5. parity slice: USOT* tracking at full width (width 64, channels 256,
     memory queue 7), random seeded weights with calibrated BN stats, two
     synthetic 480x640 videos (instance 255 and 271) through
     `USOTTracker` + `ModelRunner`; the network's outputs against the
     same model on the CPU; K1 launched exactly 3 times per frame;
  6. tools: `usot_tpu_torch.tools.bench_xcorr` and `.bench_memhead` at
     reduced --iters; the K1, K2 and K3 wrappers are called exactly as
     often as the tools' stages call them;
  7. batch engine, at `bench.py`'s configuration: `BatchScanEngine`,
     B=32, 480x640, chunk 64, 129 frames of the triangle-wave video on
     every lane; init_batch, a warm chunk under
     `torch.cuda.set_sync_debug_mode("error")` (no host sync inside a
     chunk), stage_frames, track_staged x3; K1 exactly 3 times per frame
     step; a ragged batch freezes its finished lanes exactly; lane 0's
     search features and head outputs against the same model on the CPU;
  8. scan engine: `ScanEngine` with the folded head on one video at
     instance 271 (16-px box), 32 frames at chunk 16; the same checks.
The line before the last is the `kernels` JSON object, the last
{"ok": true, "device": {...}}. Without CUDA the script exits with an
error and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from usot_tpu_torch.ops.xcorr_kernel import launch_counts, \
    reset_launch_counts
from usot_tpu_torch.tools.timing import card_line, time_call_ms, \
    time_device_ms

# The parity and crop numerics are f32: cuDNN convolutions default to
# TF32 on Ampere and later, which keeps ~3 decimal digits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# H100 SXM data sheet (dense): HBM3 bandwidth, FP32 rate without tensor
# cores. The kernels' FMAs run on the FP32 units for f32 and bf16 input.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TAPS = 5 * 5 + 3 * 5 + 5 * 3
_PALLAS = "usot_tpu/ops/pallas/xcorr_kernel.py"
KERNELS = {
    "K1": dict(name="xcorr_groupdw", route="cuda",
               source="usot_tpu_torch/ops/csrc/xcorr_groupdw.cu",
               replaces=f"{_PALLAS}:135",
               tpu_kernel=f"{_PALLAS}::xcorr_groupdw_pallas"),
    "K2": dict(name="xcorr_depthwise_multi", route="cuda",
               source="usot_tpu_torch/ops/csrc/xcorr_depthwise.cu",
               replaces=f"{_PALLAS}:65",
               tpu_kernel=f"{_PALLAS}::xcorr_depthwise_multi_pallas"),
    "K3": dict(name="xcorr_depthwise_pairwise", route="cuda",
               source="usot_tpu_torch/ops/csrc/xcorr_depthwise.cu",
               replaces=f"{_PALLAS}:190",
               tpu_kernel=f"{_PALLAS}::xcorr_depthwise_pallas"),
}
OUT_DIR = "chiprun_out"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def no_host_sync(device):
    """Raise on any host synchronisation inside the block (CUDA only)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------- kernel checks

def roofline(inputs, out, taps):
    """Least time for the work on an H100 SXM: each input read once and
    the output written once at the HBM rate, against `taps` FMAs per
    output at the FP32 rate. Returns (ms, 'bytes' | 'operations')."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
    flops = 2.0 * out.numel() * taps
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(xs, ks, out):
    """K1's roofline: three scales, 55 taps."""
    return roofline([*xs, *ks], out, TAPS)


def _tolerance(ref, dtype):
    # f32: the Pallas kernels' tolerance (tests/test_ops.py:260),
    # scale-aware. bf16: the plain version runs on the same bf16 values
    # in f32; the kernel rounds its f32 sum to bf16 once (unit roundoff
    # 2^-8), so 2^-7 of the largest output leaves room for the f32
    # summation order.
    scale = max(float(ref.abs().max()), 1.0)
    return (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale


def _compare(tag, label, out, ref, dtype, device):
    sync(device)
    check(out.shape == ref.shape and out.dtype == dtype,
          f"{tag} kernel {label}: shape/dtype {tuple(out.shape)} "
          f"{out.dtype}, expected {tuple(ref.shape)} {dtype}")
    err = float((out.float() - ref.float()).abs().max())
    tol = _tolerance(ref, dtype)
    check(err <= tol, f"{tag} kernel {label}: max |err| {err} > {tol}")
    return err, tol


def _timings(kernel_fn, plain_fn, lib_fn):
    return {"ms": time_device_ms(kernel_fn),
            "call_ms": time_call_ms(kernel_fn),
            "plain_ms": time_device_ms(plain_fn, inner=2, reps=20),
            "library_ms": time_device_ms(lib_fn)}


def groupdw_inputs(rng, b, m, c, hx, wx, dtype, device):
    """Three scales (5x5, 3x5, 5x3 kernels) meeting at one Ho x Wo."""
    x_shapes = [(b, hx, wx, c), (b, hx - 2, wx, c), (b, hx, wx - 2, c)]
    k_shapes = [(b, m, 5, 5, c), (b, m, 3, 5, c), (b, m, 5, 3, c)]
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          .to(device=device, dtype=dtype) for s in x_shapes]
    ks = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          .to(device=device, dtype=dtype) for s in k_shapes]
    return xs, ks


def _grouped_conv(x, k):
    """(B, Hx, Wx, C) x (B, M, Hk, Wk, C) as ONE grouped convolution
    (groups B*C, M outputs each) on inputs laid out for cuDNN. Returns
    (run, to_bmhwc): a function of no arguments and the map of its
    output back to (B, M, Ho, Wo, C)."""
    b, hx, wx, c = x.shape
    m = k.shape[1]
    x_nchw = x.permute(0, 3, 1, 2).reshape(1, b * c, hx, wx).contiguous()
    w_oihw = k.permute(0, 4, 1, 2, 3).reshape(b * c * m, 1, *k.shape[2:4]) \
        .contiguous()

    def to_bmhwc(out):
        ho, wo = out.shape[2], out.shape[3]
        return out.reshape(b, c, m, ho, wo).permute(0, 2, 3, 4, 1)

    return (lambda: F.conv2d(x_nchw, w_oihw, groups=b * c)), to_bmhwc


def groupdw_library(xs, ks):
    """K1's function as three grouped convolutions (one group per
    (b, c), M outputs each) and two adds: the reference's grouped-conv
    formulation (ref: lib/models/connect.py:147-157) without the repeat
    of the search map. A yardstick only; the port never calls it."""
    runs = [_grouped_conv(x, k) for x, k in zip(xs, ks)]

    def run():
        out = runs[0][0]()
        out = out + runs[1][0]()
        return out + runs[2][0]()

    return run, runs[0][1]


def kernel_checks(kernel, reference, device, c=256, timed=True):
    """Holds K1 (`kernel`) against `reference` on the parity tracker's
    and the batch engine's shapes, a ragged one and bf16. Returns
    per-shape records."""
    rng = np.random.default_rng(0)
    cases = []
    for inst, s in ((255, 31), (271, 33)):
        for m in (1, 7):
            cases.append((f"instance {inst}, B=1, M={m}, C={c}, f32",
                          (1, m, c, s - 2, s - 2), torch.float32, True))
    for m in (1, 7):
        cases.append((f"engine, instance 255, B=32, M={m}, C={c}, f32",
                      (32, m, c, 29, 29), torch.float32, True))
    cases.append(("ragged B=3, M=5, C=96, f32", (3, 5, 96, 11, 13),
                  torch.float32, False))
    cases.append((f"instance 255, B=1, M=7, C={c}, bf16",
                  (1, 7, c, 29, 29), torch.bfloat16, False))
    # edges of the tiled kernel: a partial 32-channel slab, odd C (no
    # 16-byte copies), M in no grouping, Ho and Wo not multiples of the
    # band or of the 9-wide strip (Wo=33: four strips, the last of 6),
    # Wo over one 36-column tile
    for label, shape, dtype in (
            ("edge C=40, B=2, M=3, Ho=Wo=25", (2, 3, 40, 29, 29), "f32"),
            ("edge odd C=37, B=2, M=3, Ho=13, Wo=16", (2, 3, 37, 17, 20),
             "bf16"),
            ("edge odd C=37, B=2, M=3, Ho=13, Wo=16", (2, 3, 37, 17, 20),
             "f32"),
            ("edge M=5, B=2, C=64, Ho=27, Wo=33", (2, 5, 64, 31, 37), "f32"),
            (f"edge Ho=13, Wo=27, B=4, M=7, C={c}", (4, 7, c, 17, 31),
             "f32"),
            (f"edge Wo=33, B=1, M=1, C={c}", (1, 1, c, 29, 37), "bf16"),
            ("edge Wo=40 (two column tiles), B=1, M=2, C=32",
             (1, 2, 32, 9, 44), "f32")):
        cases.append((f"{label}, {dtype}", shape,
                      torch.float32 if dtype == "f32" else torch.bfloat16,
                      False))
    records = []
    for label, (b, m, cc, hx, wx), dtype, production in cases:
        xs, ks = groupdw_inputs(rng, b, m, cc, hx, wx, dtype, device)
        out = kernel(xs, ks)
        ref = reference([x.float() for x in xs], [k.float() for k in ks])
        err, tol = _compare("GroupDW", label, out, ref, dtype, device)
        rec = {"shape": label, "x": [list(x.shape) for x in xs],
               "k": [list(k.shape) for k in ks], "out": list(out.shape),
               "max_abs_err": err, "tol": tol}
        rec["bound_ms"], rec["bound_by"] = bound(xs, ks, out)
        if production:
            lib_run, to_bmhwc = groupdw_library(xs, ks)
            lib_err = float((to_bmhwc(lib_run()) - ref).abs().max())
            check(lib_err <= tol, f"grouped-conv yardstick {label}: "
                  f"max |err| {lib_err} > {tol}")
            if timed:
                rec.update(_timings(lambda: kernel(xs, ks),
                                    lambda: reference(xs, ks), lib_run))
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def single_cases(c=256):
    """(tag, B, M or None, C, hx, wx, hk, wk, dtype) of the K2 (M given)
    and K3 (M None) checks."""
    f32, bf16 = torch.float32, torch.bfloat16
    half, ragged_c = max(c // 2, 1), max(3 * c // 8, 1)
    cases = []
    for tag, b, m in (("K3", 32, None), ("K3", 224, None), ("K2", 32, 7)):
        for dtype in (f32, bf16):
            cases.append((tag, b, m, c, 29, 29, 5, 5, dtype))
    for tag, m in (("K3", None), ("K2", 3)):
        # tests/test_ops.py:225-227
        cases += [(tag, 2, m, c, 31, 31, 5, 5, f32),
                  (tag, 1, m, c, 27, 29, 3, 5, f32),
                  (tag, 2, m, half, 29, 27, 5, 3, f32)]
        for dtype in (f32, bf16):  # ragged: B=3, C=96, Wo=13
            cases.append((tag, 3, m if m is None else 5, ragged_c, 12, 15,
                          4, 3, dtype))
    # edges of the tiled kernel (see `kernel_checks`), B=1 at M=1 and 7
    for tag, m in (("K3", None), ("K2", 5)):
        cases += [(tag, 2, m, 40, 29, 29, 5, 5, f32),
                  (tag, 2, m, 37, 17, 20, 5, 5, bf16),
                  (tag, 2, m, 37, 31, 37, 5, 5, f32)]
    cases += [("K3", 1, None, c, 17, 37, 5, 5, f32),
              ("K2", 1, 7, c, 31, 31, 5, 5, f32),
              ("K2", 1, 7, c, 17, 31, 5, 5, bf16),
              ("K3", 1, None, 32, 9, 44, 3, 5, bf16),  # two column tiles
              ("K2", 1, 3, 32, 9, 44, 5, 5, f32)]
    return cases


def single_checks(kernels, references, device, c=256, timed=True):
    """Holds K2 and K3 against their plain versions (`kernels` and
    `references` map "K2"/"K3" to functions) and the grouped-conv
    yardstick at every shape, and times all three. Returns per-shape
    records with the tag of the kernel."""
    rng = np.random.default_rng(1)
    records = []
    for tag, b, m, cc, hx, wx, hk, wk, dtype in single_cases(c):
        k_shape = (b, hk, wk, cc) if m is None else (b, m, hk, wk, cc)
        x = torch.from_numpy(rng.normal(size=(b, hx, wx, cc))
                             .astype(np.float32)).to(device, dtype)
        k = torch.from_numpy(rng.normal(size=k_shape)
                             .astype(np.float32)).to(device, dtype)
        label = (f"B={b}" + ("" if m is None else f", M={m}")
                 + f", {hx}x{wx} / {hk}x{wk}, C={cc}, "
                 + ("f32" if dtype == torch.float32 else "bf16"))
        kernel, reference = kernels[tag], references[tag]
        out = kernel(x, k)
        ref = reference(x.float(), k.float())
        err, tol = _compare(tag, label, out, ref, dtype, device)
        rec = {"kernel": tag, "shape": label, "x": list(x.shape),
               "k": list(k.shape), "out": list(out.shape),
               "max_abs_err": err, "tol": tol}
        rec["bound_ms"], rec["bound_by"] = roofline([x, k], out, hk * wk)
        lib_run, to_bmhwc = _grouped_conv(x, k if m is not None
                                          else k[:, None])
        lib = to_bmhwc(lib_run())
        lib_err = float((lib.float() - ref.reshape(lib.shape)).abs().max())
        check(lib_err <= tol, f"grouped-conv yardstick {tag} {label}: "
              f"max |err| {lib_err} > {tol}")
        if timed:
            rec.update(_timings(lambda: kernel(x, k),
                                lambda: reference(x, k), lib_run))
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


# ------------------------------------------------------------ parity slice

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


def build_model(device, width=64, channels=256, n_iter=10):
    """Full-width USOT* (queue 7) with random seeded weights and BN
    stats calibrated by `n_iter` train-mode passes, fused GroupDW."""
    from usot_tpu_torch.models.calibrate import calibrate_batch_stats
    from usot_tpu_torch.models.usot import build_usot, init_model

    t0 = time.perf_counter()
    model = build_usot(mem_size=7, width=width, channels=channels,
                       fused_xcorr=True)
    init_model(model, torch.Generator().manual_seed(0), device=device)
    calibrate_batch_stats(model, n_iter=n_iter)
    print(f"model: width {width}, channels {channels}, built and "
          f"calibrated ({n_iter} passes) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return model


def run_slice(device, width=64, channels=256, n_frames=21, n_iter=10,
              card=""):
    """The parity tracker at full width. Returns (model, per-video
    (record, tracker state), K1 launches on this path)."""
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.tracker.tracker import USOTTracker

    model = build_model(device, width, channels, n_iter)
    runner = ModelRunner(model, device=device)
    videos = [("instance 255, 48-px box", 48, 255),
              ("instance 271, 16-px box", 16, 271)]
    reset_launch_counts()  # the parity tracker's path starts here
    results, tracked = [], 0
    for label, box, inst in videos:
        frames, centers = synthetic_video(n_frames, box)
        tracker = USOTTracker()
        before = launch_counts()["K1"]
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
        launches = launch_counts()["K1"] - before
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
    total = launch_counts()["K1"]  # read just after the path
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


# ------------------------------------------------------------------ tools

def run_tools(iters=5):
    """Both benchmark tools once. Each stage's function calls the
    kernels' wrappers 3 + INNER times (warm-up and CUDA-graph capture);
    per call, the K3 stages make 1 (bench_xcorr, 2 stages) and 3
    (bench_memhead, repeat + 3x xcorr) K3 calls, the K2 stage 3 and the
    two GroupDW stages one K1 call each. The counts must be exactly
    that."""
    from usot_tpu_torch.tools import bench_memhead, bench_xcorr

    per_fn = {"K1": 2, "K2": 3, "K3": 5}
    expected = {k: n * (3 + bench_xcorr.INNER) for k, n in per_fn.items()}
    reset_launch_counts()  # the tools' path starts here
    records = bench_xcorr.main(["--iters", str(iters)]) \
        + bench_memhead.main(["--iters", str(iters)])
    counts = launch_counts()  # read just after the path
    check(counts == expected, f"the tools' kernel wrapper calls {counts}, "
          f"expected {expected}")
    return records, counts


# ---------------------------------------------------------------- engines

def _tracker_config(instance: str):
    from usot_tpu_torch.tracker.config import TrackerConfig

    p = TrackerConfig()
    p.instance_size = p.small_sz if instance == "small" else p.big_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def _check_track(label, pos, sz):
    check(np.all(np.isfinite(pos)), f"{label}: non-finite positions")
    check(np.all(np.isfinite(sz)) and np.all(sz >= 10),
          f"{label}: sizes {sz.min()}..{sz.max()}")


def batch_heads_vs_cpu(model, engine, state, frames, device, tol=1e-3):
    """One frame step of lane 0 against the same model and carry on the
    CPU, scale-aware at `tol` (as `parity_vs_cpu`), stage by stage and
    end to end:
    * `search_features`: device crop and backbone;
    * `heads/cls`, `heads/bbox`, `heads/cls_mem`: the CPU's heads fed the
      card's search features, the boxes as the head outputs them;
    * `cls`, `cls_mem` and `bbox_exponent` end to end, each side on its
      own backbone. The boxes are exp(0.1 * conv + bias); random
      full-width weights drive that exponent past exp's overflow
      (~88.7), where the backbones' f32 gap (a few 1e-4 of the features'
      scale) moves the exponent by hundredths, and the largest boxes by
      ~5e-3 of themselves. So end to end the bbox
      head is held in its exponent, and `bbox_exp` records the gap of
      the exp'd boxes unchecked.
    Each record keeps the scale it was held at."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine, EngineState

    cpu_engine = BatchScanEngine(
        copy.deepcopy(model).cpu(), engine.p, engine.im_h, engine.im_w,
        batch=1, max_frames=engine.max_frames, chunk=1,
        fused_head=engine.fused is not None, device="cpu")
    lane0 = EngineState(*[
        tuple(tuple(t[:1].cpu() for t in side) for side in f)
        if i == 2 else tuple(t[:1].cpu() for t in f) if i in (3, 4)
        else f[:1].cpu() for i, f in enumerate(state)])
    with torch.inference_mode():
        _, xf_dev = engine._search(state, frames, engine._avg_b,
                                   engine._im_hw_b)
        _, xf_cpu = cpu_engine._search(lane0, frames[:1].cpu(),
                                       engine._avg_b[:1].cpu(),
                                       engine._im_hw_b[:1].cpu())
        out_dev = [t[:1].cpu() for t in engine._heads(state, xf_dev)]
        out_same = cpu_engine._heads(lane0, xf_dev[:1].cpu())
        out_cpu = cpu_engine._heads(lane0, xf_cpu)

    errs = {}

    def gap(a, b):
        a, b = a.double(), b.double()
        scale = max(float(b.abs().max()), 1.0)
        err = float((a - b).abs().max())
        return {"scaled_err": err / scale, "max_abs_err": err,
                "scale": scale}

    def hold(key, a, b):
        # random full-width weights can overflow the bbox exp: the same
        # cells must overflow on both devices, the rest must agree
        finite = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), finite) and bool(finite.any()),
              f"engine lane 0 {key}: non-finite cells differ")
        errs[key] = gap(a[finite], b[finite])
        check(errs[key]["scaled_err"] <= tol,
              f"engine lane 0 {key} GPU vs CPU: {errs[key]}, tol {tol}")

    hold("search_features", xf_dev[:1].cpu(), xf_cpu)
    for i, name in enumerate(("cls", "bbox", "cls_mem")):
        hold(f"heads/{name}", out_dev[i], out_same[i])
    hold("cls", out_dev[0], out_cpu[0])
    hold("bbox_exponent", torch.log(out_dev[1]), torch.log(out_cpu[1]))
    hold("cls_mem", out_dev[2], out_cpu[2])
    finite = torch.isfinite(out_dev[1]) & torch.isfinite(out_cpu[1])
    errs["bbox_exp"] = gap(out_dev[1][finite], out_cpu[1][finite])
    return errs


def run_batch_engine(model, device, batch=32, n_frames=129, chunk=64,
                     repeats=3, h=480, w=640, ragged_frames=20, card=""):
    """`bench.py`'s configuration through the port's BatchScanEngine."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine, \
        synthetic_video as bench_video
    from usot_tpu_torch.tracker.runner import ModelRunner

    runner = ModelRunner(model, device=device)
    p = _tracker_config("small")
    frames = bench_video(n_frames, h=h, w=w)
    engine = BatchScanEngine(model, p, canvas_h=h, canvas_w=w, batch=batch,
                             max_frames=max(256, n_frames + 8), chunk=chunk,
                             device=device)
    videos = [(frames[0], np.array([200.0, 240.0]), np.array([60.0, 60.0]))
              for _ in range(batch)]
    t0 = time.perf_counter()
    state = engine.init_batch(videos, runner)
    sync(device)
    init_s = time.perf_counter() - t0
    single = np.stack(frames[1:])
    all_frames = np.broadcast_to(single[None], (batch,) + single.shape)
    warm = engine.stage_frames(all_frames[:, :chunk], np.full(batch, chunk))

    reset_launch_counts()  # the batch engine's path starts here
    t0 = time.perf_counter()
    with no_host_sync(device):
        state, outs = engine.run_chunk(state, warm[0][1], warm[0][2])
    pos, sz, _ = engine._collate([(chunk, outs)])
    warm_s = time.perf_counter() - t0
    _check_track("batch engine warm chunk", pos, sz)
    steps = chunk

    rest = all_frames[:, chunk:]
    n_rest = rest.shape[1]
    staged = engine.stage_frames(rest, np.full(batch, n_rest))
    fps, step_ms = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, pos, sz, score = engine.track_staged(state, staged)
        dt = time.perf_counter() - t0
        fps.append(batch * n_rest / dt)
        step_ms.append(dt / n_rest * 1e3)
        steps += n_rest
        _check_track("batch engine staged", pos, sz)
    k1 = launch_counts()["K1"]  # read just after the path
    if device.type == "cuda":
        check(k1 == 3 * steps, f"batch engine: {k1} K1 launches for "
              f"{steps} frame steps, expected {3 * steps}")
    check(int(state.mem_len.min()) == 1 + steps,
          f"batch engine mem_len {state.mem_len.tolist()}")
    heads = batch_heads_vs_cpu(model, engine, state, staged[0][1][0],
                               device)

    # ragged lanes: lane i tracks n_valid[i] frames, then freezes
    rag = BatchScanEngine(model, p, canvas_h=h, canvas_w=w, batch=batch,
                          max_frames=engine.max_frames,
                          chunk=ragged_frames, device=device)
    n_valid = ragged_frames - (ragged_frames // 5) * (np.arange(batch) % 5)
    st = rag.init_batch(videos, runner)
    before = launch_counts()["K1"]
    st, rpos, rsz, _ = rag.track_batch(st, all_frames[:, :ragged_frames],
                                       n_valid)
    ragged_launches = launch_counts()["K1"] - before
    last = n_valid - 1
    lanes = np.arange(batch)
    check(np.array_equal(st.pos.cpu().numpy(), rpos[lanes, last])
          and np.array_equal(st.sz.cpu().numpy(), rsz[lanes, last]),
          "ragged batch: a finished lane's carry moved after its last "
          "valid frame")
    check(np.array_equal(st.mem_len.cpu().numpy(), n_valid + 1),
          f"ragged batch mem_len {st.mem_len.tolist()}, expected "
          f"{(n_valid + 1).tolist()}")
    rec = {"engine": "BatchScanEngine", "batch": batch, "canvas": [h, w],
           "chunk": chunk, "frames": n_frames, "instance": p.instance_size,
           "init_s": init_s, "warm_chunk_s": warm_s,
           "fps_median": statistics.median(fps), "fps": fps,
           "ms_per_step_median": statistics.median(step_ms),
           "ms_per_step": step_ms, "frame_steps": steps,
           "k1_launches": k1, "k1_launches_per_step": k1 / steps,
           "ragged_n_valid": n_valid.tolist(),
           "ragged_k1_launches": ragged_launches,
           "lane0_heads_gpu_vs_cpu": heads,
           "final_pos_lane0": pos[0, -1].tolist(), "card": card}
    print(json.dumps(rec), flush=True)
    return rec, k1 + ragged_launches


def run_scan_engine(model, device, n_frames=33, chunk=16, h=480, w=640,
                    box=16, card=""):
    """ScanEngine with the folded head on one small-target video."""
    from usot_tpu_torch.tracker.engine import ScanEngine, \
        synthetic_video as bench_video
    from usot_tpu_torch.tracker.runner import ModelRunner

    check(box * box / float(h * w) < 0.004,
          "the tracker's rule would not pick instance 271")
    runner = ModelRunner(model, device=device)
    p = _tracker_config("big")
    frames = bench_video(n_frames, h=h, w=w, box=box)
    engine = ScanEngine(model, p, im_h=h, im_w=w, max_frames=64,
                        chunk=chunk, fused_head=True, device=device)
    state = engine.init_state(frames[0], np.array([200.0, 240.0]),
                              np.array([box, box], np.float64), runner)
    warm = torch.from_numpy(np.stack(frames[1:chunk + 1])).to(device)
    valid = torch.ones(chunk, dtype=torch.bool, device=device)

    reset_launch_counts()  # the scan engine's path starts here
    with no_host_sync(device):
        state, outs = engine.run_chunk(state, warm, valid)
    _check_track("scan engine warm chunk", outs[0].cpu().numpy(),
                 outs[1].cpu().numpy())
    t0 = time.perf_counter()
    state, pos, sz, score = engine.track_frames(state,
                                                np.stack(frames[chunk + 1:]))
    dt = time.perf_counter() - t0
    k1 = launch_counts()["K1"]  # read just after the path
    steps = n_frames - 1
    _check_track("scan engine", pos, sz)
    check(len(pos) == steps - chunk, f"scan engine: {len(pos)} outputs")
    if device.type == "cuda":
        check(k1 == 3 * steps, f"scan engine: {k1} K1 launches for "
              f"{steps} frames, expected {3 * steps}")
    check(int(state.mem_len) == 1 + steps,
          f"scan engine mem_len {int(state.mem_len)}")
    rec = {"engine": "ScanEngine", "fused_head": True,
           "instance": p.instance_size, "chunk": chunk, "frames": steps,
           "ms_per_frame": dt / len(pos) * 1e3, "k1_launches": k1,
           "final_pos": pos[-1].tolist(), "card": card}
    print(json.dumps(rec), flush=True)
    return rec, k1


# ------------------------------------------------------------------- main

def ptxas_report(built):
    """Prints each kernel instantiation's `-Xptxas -v` lines (entry,
    registers, stack and spills) and fails on any spill. Returns the
    lines by source."""
    report = {}
    for src, (_, log) in built.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        for line in lines:
            print(f"  ptxas {src}: {line}", flush=True)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            check(spills is None or spills.groups() == ("0", "0"),
                  f"ptxas {src}: register spills: {line}")
        report[src] = lines
    return report



def kernel_line(tag, rec, launches, by_path):
    return {**KERNELS[tag], "launches": launches, "launches_by_path": by_path,
            "shape": rec["shape"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "call_ms": rec["call_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from usot_tpu_torch.ops import xcorr_kernel
    from usot_tpu_torch.ops.xcorr import (xcorr_depthwise_multi_reference,
                                          xcorr_depthwise_pairwise_reference,
                                          xcorr_groupdw_reference)

    t_start = time.perf_counter()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    built = xcorr_kernel.build_all()
    print(f"build: {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = ptxas_report(built)

    k1_records = kernel_checks(xcorr_kernel.xcorr_groupdw_cuda,
                               xcorr_groupdw_reference, device)
    single_records = single_checks(
        {"K2": xcorr_kernel.xcorr_depthwise_multi_cuda,
         "K3": xcorr_kernel.xcorr_depthwise_pairwise_cuda},
        {"K2": xcorr_depthwise_multi_reference,
         "K3": xcorr_depthwise_pairwise_reference}, device)

    model, results, slice_k1 = run_slice(device, card=card)
    errs = parity_vs_cpu(model, results, device)
    tool_records, tool_counts = run_tools()
    batch_rec, batch_k1 = run_batch_engine(model, device, card=card)
    scan_rec, scan_k1 = run_scan_engine(model, device, card=card)

    def pick(records, tag, shape):
        return next(r for r in records
                    if r.get("kernel", "K1") == tag and r["shape"] == shape)

    k1_paths = {"parity_slice": slice_k1, "batch_engine": batch_k1,
                "scan_engine": scan_k1}
    kernels = [
        kernel_line("K1", pick(k1_records, "K1",
                               "engine, instance 255, B=32, M=7, C=256, f32"),
                    sum(k1_paths.values()),
                    {**k1_paths, "tools": tool_counts["K1"]}),
        kernel_line("K2", pick(single_records, "K2",
                               "B=32, M=7, 29x29 / 5x5, C=256, bf16"),
                    tool_counts["K2"], {"tools": tool_counts["K2"]}),
        kernel_line("K3", pick(single_records, "K3",
                               "B=32, 29x29 / 5x5, C=256, bf16"),
                    tool_counts["K3"], {"tools": tool_counts["K3"]}),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched")
    summary = {"card": card, "kind": kind, "kernels": kernels,
               "ptxas": ptxas,
               "k1_shapes": k1_records, "k2_k3_shapes": single_records,
               "slice": [r for r, _ in results], "gpu_vs_cpu": errs,
               "tools": tool_records, "batch_engine": batch_rec,
               "scan_engine": scan_rec,
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
