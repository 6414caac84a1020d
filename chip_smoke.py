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
     batch engine's two (B=32, instance 255, M in {1, 7}) in f32 and in
     bf16, C=256, a ragged shape, bf16 at B=1 and the tiled kernel's
     edges (C=40, odd C, M=5, Ho 13/27, Wo 27/33/40), with its time, the
     plain version's, a grouped-conv library call's (cuDNN, in the
     inputs' dtype) and the bound (bytes at the HBM rate, operations at
     the peak of the inputs' type);
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
     instance 271 (16-px box), 32 frames at chunk 16; the same checks;
  9. protocols, through the test CLI's functions (`usot_tpu_torch.cli.
     test`) on in-memory 480x640 videos: the VOT restart protocol at B=8,
     chunk 16 (8 videos of 40-64 frames; a same-chunk and a cross-chunk
     restart and an instance-size spill forced by the ground truth), its
     restart skeletons equal to `--engine scan`'s; lane refill (10 videos
     of 8-80 frames on 4 lanes), every video covered, and a splice's
     lanes held bitwise; `track_batch_roi` at `suggest_roi`'s size, and
     in one-frame chunks of which at least the first is accepted,
     against `track_batch` on the same B=8 1280x720 frames within
     1e-2 px, with the bytes uploaded; `run_chunk(donate=False)` with
     full rings bitwise non-mutating, and the cost of its ring copies at
     B=8, 2048 frames; a frame step's time at B=8 and B=4. K1 launched
     on each protocol.
 11. bf16 (run after phase 9, before phase 10): phase 7's engine and
     weights in bf16 (`build_usot(dtype=torch.bfloat16)`, float32
     parameters and BN stats), the same checks (a warm chunk under
     `set_sync_debug_mode("error")`, K1 three times per frame step, all
     of them on bf16 inputs, the rings in bf16), lane 0 against the same
     bf16 model on the CPU stage by stage at `BF16_LANE_TOL`, eval-mode
     BN's card branch alone against flax's rounding (`BN_FLIP_SHARE`,
     one ulp), and its ms per step and frames/s beside phase 7's f32
     figures; then the trained
     w8c32 fixture, read by the port's msgpack reader, tracked by
     `ScanEngine` on the card in f32 and bf16, each step held against the
     CPU's from the same carry, the trajectories' deviations recorded;
 10. training, through the trainer's function (`usot_tpu_torch.cli.train.
     train`) at full width, 127/255, 4 memory frames, B=12, on a seeded
     synthetic shard set in `usot_tpu.cli.make_shards`'s format: the
     staged schedule cut to 6 epochs (cycle memory from 3, backbone
     unfrozen at 5, 2 steps each), finite losses, the record's schedule
     fields, checkpoints of epochs 5 and 6 only, a resume from epoch 5
     within 1e-3 of the unbroken run's epoch 6; one step of three
     programs at B=1 against the CPU (losses 1e-4 relative, gradients and
     BN stats 1e-3 scale-aware; the unfrozen one in float64, its float32
     gradients being ill-conditioned); ms per step, samples/s and peak memory
     of the naive and cycle-memory steps, frozen and unfrozen, with remat
     (same loss within 1e-5, lower peak) and accum=2; a `torch.profiler`
     breakdown of an unfrozen cycle-memory step. Training builds the
     model unfused, so it launches none of the three kernels (recorded
     as `launches_by_path["training"]`);
 12. the trainer's default path (run after phase 10): `cli.train.train`
     with no shard set, in bf16 (`--dtype bfloat16`, float32 parameters,
     BN stats and momentum) at phase 10's width and schedule, from the
     live loader (`USOTDataset` through the threaded `DataLoader`, the
     host's cores up to 8 threads) over `tools/train_synthetic.py`'s
     dataset made in memory (24 videos of 12 511x511 frames, handed to
     the dataset through its reader: the card has no image decoder): the
     record's schedule fields, checkpoints, a resume from epoch 5 within
     1e-2 of the unbroken run's epoch 6; one bf16 step of three programs
     at B=1 against the CPU's bf16, within twice the CPU's own
     float32-vs-bf16 gap; ms per step, samples/s and peak memory of the
     naive and cycle-memory bf16 steps, frozen and unfrozen, beside
     phase 10's float32 ones; a profiler breakdown of the bf16
     unfrozen cycle-memory step; the live loader's samples/s alone
     (naive and cycle memory, 1 and N threads) and pipelined through
     `device_prefetch` into the bf16 step over 4 timed steps, with the
     card's idle share
     (computed from the profiled step's device time and the pipelined
     wall time). No correlation kernel launched
     (`launches_by_path["training_bf16"]`);
 13. pseudo-label mining (run after phase 12), through `cli.parse_flow`'s
     functions on a seeded synthetic 720x1280 video of 48 frames held in
     memory (a textured object moving over a panning textured
     background): `inference_sequence` with `FlowHelper` at 384x640 on
     the card (PWCLite in 3-frame mode, `init_pwclite` weights from a
     fixed generator, the adaptive interval, flow_to_bbox, the DP), the
     crop511 images (`crop_video_frames`, an in-memory writer) and
     train.json (`build_train_json(quality_gate=False)`, the CLI's
     `--keep_all`): one crop per frame, 511x511x3, train.json
     well-formed. Held against the CPU, the card's loop teacher-forced:
     every forward's flow within 1e-3 scale-aware, each interval
     decision equal where the CPU's margin from 8 / 16 px exceeds the
     flow gap, each kept flow's candidate boxes equal where no mask pixel
     flips (and every flip within the gap of the threshold), margins
     recorded. Recorded: ms per forward (device time from a CUDA graph,
     host clock with the sync, the loop's step with its max|flow| read,
     the flow's copy to the host), conv GFLOP and TFLOP/s, a
     `torch.profiler` breakdown (convolutions, cost volume, warp, resize,
     other) with the launches per forward, forwards per sampled frame,
     host ms per frame in flow_to_bbox, the DP and the crop, seconds
     per video and frames mined per second. No correlation kernel
     launched (`launches_by_path["preprocessing"]`).
 14. the user's last steps (run after phase 13): (a) the VOT2020/TraX
     entry point, `cli.vot_wrapper.run` at full width on seeded random
     weights with calibrated BN (`cli.test.load_model`'s route, a saved
     `.pth`), run in a thread over a pair of pipes with this script as
     the toolkit and frames held in memory: a `rectangle` session on a
     480x640 video and a `mask` (VOT2020) session on a 720x1280 video
     started from a mask, 60 frames each; a confidence with every state,
     every mask nonempty, the regions those of `USOTTracker` +
     `ModelRunner` tracking the same frames directly (rectangles within
     1e-3 px, masks equal), K1 exactly 3 times per tracked frame
     (`launches_by_path["trax"]`); ms per frame through the protocol
     beside the tracker alone, the mask's RLE encode and decode at 720p;
     (b) `cli.evaluate` on the card's host scoring phase 9's VOT-restart
     and refill result files (dataset JSONs and first frames as PNGs
     written beside them): every video scored, each video's failures
     phase 9's restarts, AUC, EAO and accuracy finite, its seconds;
     (c) the one-key chain in this process (`cli.onekey.main` with a
     config dict and `onekey.in_process`): one mined 720x1280 video of
     24 frames, two epochs of 2 steps at full width and B=12 (naive,
     then cycle memory), `test_epochs` over both checkpoints on a
     2-video 480x640 benchmark (30 frames, the parity engine),
     `evaluate`; every stage's artifacts, a finite AUC, `STAGE_TIMES`,
     K1 3 times per tested frame (`launches_by_path["onekey"]`);
     (d) `usot_tpu_torch.entry.entry()` once: its output shapes and K1's
     three launches (`launches_by_path["entry"]`).
 15. data parallelism (run after phase 14), one card standing in for two:
     (a) `BatchScanEngine(mesh=make_mesh(devices=[cuda:0, cuda:0]))` at
     `bench.py`'s configuration (B=32 as two shards of 16, 480x640,
     chunk 64, 129 frames) on phase 7's weights, in f32 and in bf16:
     teacher-forced for the first chunk's 64 steps (each step from the
     unsharded engine's carry) against the unsharded engine: in f32
     every lane's positions, sizes, scores and memory confidences at
     scale-aware 1e-3; in bf16 the first step's search features and
     heads per shard at `BF16_LANE_TOL`, and on every step the scores
     and memory confidences at `BF16_LANE_TOL` on the lanes whose
     score-map argmax agrees with the unsharded engine's (at least half
     of them; on random weights bf16 rounding flips it between
     near-equal cells), the positions and sizes recorded; a warm chunk
     under `torch.cuda.set_sync_debug_mode("error")`; K1 exactly 3 x 2
     launches per frame step, each on 16 lanes
     (`launches_by_path["sharded"]`); a splice into lanes 15 and 16,
     across the shard boundary, against the unsharded engine's; ms per
     step and frames/s beside phases 7 and 11 (the cost of the split on
     one card, not a scaling figure); the trained w8c32 fixture's
     sharded tracks within 2e-3 px of its unsharded ones, f32 and bf16;
     (b) two training ranks on the card over gloo, full width, B=12 per
     rank (global 24), 4 memory frames: one step each of naive frozen,
     cycle frozen, cycle unfrozen and cycle frozen with accum=2 against
     one process on the card with the global batch (losses 1e-4
     relative, gradients 1e-3 scale-aware, the ranks' parameters equal
     bitwise; unfrozen: the BN running stats within 1e-4, the gradient
     gap recorded), and with BN sync off the frozen cycle step's BN
     stats missing that bound by far; peak memory and ms per step per
     rank beside phase 10's;
     (c) `cli.train.train` with `--devices 1` over NCCL (a group of one)
     for 2 steps, and `entry.dryrun_multichip(2)` (two gloo ranks on the
     card).
 16. trained weights (run after phase 15): (a) `usot_tpu_torch.tools.
     train_full_schedule` through its subprocess path at full width
     (64/256, B=8, 4 memory frames) at its defaults but 16 samples (2
     steps) per epoch, not 32 (the tool's 32 took 312 s of the time
     limit on a slow host): the 30-epoch schedule (memory at 6,
     unfreezing at 10, shifts at 10 and 20, checkpoints from 5), unbroken,
     SIGKILLed in epoch 16 and resumed from `checkpoint_e15.pth`, in
     deterministic mode: every transition, the prefix and resume deltas
     at 0.0, the loss falling, no correlation kernel launched by the
     children; the sha256 of `checkpoint_e30.pth` recorded; (b) `tools.
     accuracy_parity_run` on it (6 videos of 40 frames at 360x360): the
     f32 batch engine's AUC within 0.005 of the parity tracker's, the
     trained AUC above calibrated random weights', bf16's OPE gap
     recorded (these weights do not hold their targets, so an OPE gap
     measures the chaos after the loss; `PERF.md`), and bf16's
     decisions held teacher-forced: every step from the f32 engine's
     carry, the argmax agreeing on at least half the lane-steps, scores
     and memory confidences within `BF16_LANE_TOL` where it does; JAX's
     figures printed beside; (c) the batch engine free-running at B=16
     and 32 on phase 7's video (65 frames) in f32 and bf16 on the
     trained weights, every box finite; (d) phase 9's ROI leg on them (1e-2 px), its `roi_*`
     telemetry recorded. K1 launches of (b)-(d):
     `launches_by_path["trained"]`.
 17. the measuring entry points (run after phase 16, on its weights):
     (a) `usot_tpu_torch.tools.bench.run` at `bench.py`'s defaults (B=32,
     480x640, 129 frames, chunk 64, stream chunk 16, ROI auto, 5 staged
     repeats) in bf16 and in f32, each run's JSON line printed: the
     trajectory finite, every leg run (or the ROI leg's skip logged), K1
     launched 3 times per frame step of the staged leg, the compile
     watch reporting no nvcc build (phase 2 built the kernels); (b)
     `tools.vot_protocol_bench` cut to 6 videos of 100-150 frames at
     360x480 (8 of 150-225 took 77 s on a slow host, the scan engine's
     B=1 run 54 s of it), chunk 32, 8 lanes, both
     engines: one result row per frame of every video in both, the
     spill video spilled in the batch run, the skeletons identical in
     at least half the videos, and boxes on identical skeletons within
     the lockstep tolerance (2e-3 px in f32, `tests/test_lockstep.py:78`)
     for the first 3 steps after every init, over at least one frame,
     the whole distribution recorded; (c) `tools.bench_train`
     at its defaults with `--iters 3` in f32 and bf16: losses finite,
     ms per step, samples/s and peak memory recorded, no correlation
     kernel launched. K1 launches: `launches_by_path["bench"]` and
     `["votbench"]`.
 18. step attribution and the lockstep benches (run after phase 17, on
     phase 16's weights, at full width; `run_step_tools`):
     `tools.microbench_step --mfu` at B=32 in bf16, `--iters 5`, every
     stage; `tools.cliff_sweep` at B=32 and 48 on full, memhead and
     backbone; `tools.cliff_bisect` at B=32, chains A-F (F equal to E
     within 2^-7); `tools.bench_memops --frames 16 --iters 3`;
     `tools.bench_lockstep --vot --refill` cut to 48 frames, 8 videos
     and 8 lanes; then `tools.process_battery` over the JSON records
     they wrote (`chiprun_out/battery/`). Every time finite and > 0,
     every roofline share at most 100 % (above it the count is wrong),
     K1 launched by each stage that runs it (2 in the offline head, 3 in
     a memory head and the full step, 1 in `GroupDW.multi`; chain D 1,
     chain F 3) and K3 once by "xcorr shift (1 pair 7x7)", whose 7x7
     kernel is also held against its plain version; memops' bitwise
     checks; exactly `failures` restarts in every VOT repeat; refill
     and padded groups within the lockstep tolerance. K1 launches:
     `launches_by_path["microbench"]`, `["cliff"]` and
     `["lockstep_bench"]`; K3's `["microbench"]`.
Each phase's seconds are printed as it ends. The line before the last is
the `kernels` JSON object, the last
{"ok": true, "device": {...}}. Without CUDA the script exits with an
error and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import re
import shutil
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from usot_tpu_torch.ops.xcorr_kernel import launch_batches, \
    launch_counts, launch_dtypes, reset_launch_counts
from usot_tpu_torch.tools.synthetic_shards import training_sample, \
    write_training_shards
from usot_tpu_torch.tools.timing import card_line, time_call_ms, \
    time_device_ms

# The parity and crop numerics are f32: cuDNN convolutions default to
# TF32 on Ampere and later, which keeps ~3 decimal digits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# H100 SXM data sheet (dense): HBM3 bandwidth; the peak rate of each
# input type (FP32 without tensor cores, bf16 with them). A bound divides
# the operations by the peak of their inputs' type, whatever units the
# kernel itself uses (its FMAs run on the FP32 units for both).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
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
    output at the peak rate of the inputs' type. Returns
    (ms, 'bytes' | 'operations')."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
    flops = 2.0 * out.numel() * taps
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[inputs[0].dtype]
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
    for dtype in ("f32", "bf16"):
        for m in (1, 7):
            cases.append((f"engine, instance 255, B=32, M={m}, C={c}, "
                          f"{dtype}", (32, m, c, 29, 29),
                          torch.float32 if dtype == "f32"
                          else torch.bfloat16, True))
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
    Each record keeps the scale it was held at.
    A bf16 model (phase 11) is held stage by stage only, the boxes in
    their exponent (`heads/bbox_exponent`: bf16 keeps a 0.5 step there
    near exp's overflow, so up to 1 % of the cells may overflow on one
    side only, the rest compared); end to end each side's bf16 backbone
    compounds its rounding flips through ~50 layers, so `cls`, `cls_mem`
    and `bbox_exponent` are recorded, not held."""
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
                                   engine._im_hw_b, engine._origin0)
        _, xf_cpu = cpu_engine._search(lane0, frames[:1].cpu(),
                                       engine._avg_b[:1].cpu(),
                                       engine._im_hw_b[:1].cpu(),
                                       cpu_engine._origin0)
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

    bf16 = model.dtype == torch.bfloat16

    def hold(key, a, b, held=True):
        # random full-width weights can overflow the bbox exp: the same
        # cells must overflow on both devices (bf16: all but 1 %), the
        # rest must agree
        finite, other = torch.isfinite(b), torch.isfinite(a)
        differ = int((finite != other).sum())
        check((differ <= 0.01 * finite.numel() if bf16 else differ == 0)
              and bool(finite.any()),
              f"engine lane 0 {key}: non-finite cells differ ({differ})")
        both = finite & other
        errs[key] = {**gap(a[both], b[both]), "overflow_differs": differ}
        check(not held or errs[key]["scaled_err"] <= tol,
              f"engine lane 0 {key} GPU vs CPU: {errs[key]}, tol {tol}")

    hold("search_features", xf_dev[:1].cpu(), xf_cpu)
    for i, name in enumerate(("cls", "bbox", "cls_mem")):
        if bf16 and name == "bbox":
            hold("heads/bbox_exponent", torch.log(out_dev[i]),
                 torch.log(out_same[i]))
        else:
            hold(f"heads/{name}", out_dev[i], out_same[i])
    hold("cls", out_dev[0], out_cpu[0], held=not bf16)
    hold("bbox_exponent", torch.log(out_dev[1]), torch.log(out_cpu[1]),
         held=not bf16)
    hold("cls_mem", out_dev[2], out_cpu[2], held=not bf16)
    finite = torch.isfinite(out_dev[1]) & torch.isfinite(out_cpu[1])
    errs["bbox_exp"] = gap(out_dev[1][finite], out_cpu[1][finite])
    return errs


def run_batch_engine(model, device, batch=32, n_frames=129, chunk=64,
                     repeats=3, h=480, w=640, ragged_frames=20, card="",
                     tol=1e-3):
    """`bench.py`'s configuration through the port's BatchScanEngine, in
    the model's compute dtype; lane 0 held against the CPU at `tol`."""
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
    k1_dtypes = launch_dtypes()["K1"]
    if device.type == "cuda":
        check(k1 == 3 * steps, f"batch engine: {k1} K1 launches for "
              f"{steps} frame steps, expected {3 * steps}")
    check(int(state.mem_len.min()) == 1 + steps,
          f"batch engine mem_len {state.mem_len.tolist()}")
    heads = batch_heads_vs_cpu(model, engine, state, staged[0][1][0],
                               device, tol)

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
           "dtype": str(model.dtype),
           "ring_dtype": str(state.mem_enc[0].dtype),
           "k1_launches_by_dtype": k1_dtypes, "lane0_tol": tol,
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


# ---------------------------------------------------------------- bf16

# Lane 0 of the bf16 batch engine against the same bf16 model on the
# CPU, scale-aware, stage by stage. Both round to bf16 at the same
# points, but cuDNN's and the CPU's convolutions sum in other orders, so
# single elements round a bf16 ulp apart (2^-8 relative) and ~50 layers
# carry those flips on: measured on an H100 at full width, 0.013 (search
# features), 0.012 (cls, cls_mem) and 0.023 (the boxes' exponent); the
# CPU tests measured two such bf16 routes 0.01-0.03 apart
# (`tests/test_torch_port_bf16.py`).
BF16_LANE_TOL = 0.05

# Eval-mode BN on bf16 input, alone, against flax's `_normalize` written
# out in float32 and rounded once: the two associate the float32
# arithmetic differently, so where the float32 value lies within an ulp
# of a bf16 rounding midpoint they round one bf16 ulp apart; at most
# this share of the cells may (the CPU's branch measured 1 in 20736,
# `tests/test_torch_port_bf16.py`).
BN_FLIP_SHARE = 1e-3


def bn_rounding_check(device, seed=0):
    """`models.layers.BatchNorm` in eval mode on bf16 input with float32
    stats, on `device` (the card's branch, `batch_norm_elemt`, on a CUDA
    tensor; `F.batch_norm` on the CPU), against `(x - mean) *
    (rsqrt(var + eps) * scale) + bias` in float32 rounded once to bf16,
    on the inputs of `tests/test_torch_port_bf16.py`'s BN test: at most
    `BN_FLIP_SHARE` of the cells one bf16 ulp apart, none further."""
    from usot_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(seed)
    bn = BatchNorm(64).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 5, 64)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.01, 3, 64)))
        bn.weight.copy_(torch.from_numpy(rng.normal(0, 1, 64)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 1, 64)))
    bn.to(device)
    x = torch.from_numpy(rng.normal(3, 4, (4, 64, 9, 9)).astype(
        np.float32)).to(device, torch.bfloat16)
    with torch.no_grad():
        y = bn(x)
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        want = ((x.float() - bn.running_mean[:, None, None])
                * mul[:, None, None]
                + bn.bias[:, None, None]).to(torch.bfloat16)
    check(y.dtype == torch.bfloat16, f"bf16 BN returned {y.dtype}")
    flips = y != want
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs())) - 7)
    ulps = ((y.float() - want.float()).abs() / ulp)[flips]
    rec = {"device": str(device), "cells": y.numel(),
           "flips": int(flips.sum()),
           "flip_share": float(flips.float().mean()),
           "max_ulps": float(ulps.max()) if ulps.numel() else 0.0,
           "flip_share_limit": BN_FLIP_SHARE}
    check(rec["flip_share"] <= BN_FLIP_SHARE and rec["max_ulps"] <= 1.0,
          f"bf16 BN against flax's rounding: {rec}")
    return rec


def bf16_model(model):
    """`model`'s weights in a model that computes in bf16."""
    from usot_tpu_torch.models.usot import build_usot

    bf = build_usot(mem_size=model.mem_size,
                    width=model.features.features.conv1.out_channels,
                    channels=model.connect_model.cls_pred.in_channels,
                    fused_xcorr=model.connect_model.fused_xcorr,
                    dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    return bf.to(next(model.parameters()).device).eval()


def run_bf16_engine(model, device, f32_rec, card="", **kw):
    """Phase 11: phase 7 in bf16 on the same weights (`kw`: phase 7's
    sizes, for rehearsals)."""
    bn = bn_rounding_check(device)
    bf = bf16_model(model)
    rec, k1 = run_batch_engine(bf, device, card=card, tol=BF16_LANE_TOL,
                               **kw)
    rec["bn_rounding"] = bn
    steps = rec["frame_steps"]
    check(rec["ring_dtype"] == "torch.bfloat16",
          f"bf16 engine rings are {rec['ring_dtype']}")
    if device.type == "cuda":
        check(rec["k1_launches_by_dtype"] == {"bfloat16": 3 * steps},
              f"bf16 engine K1 launches {rec['k1_launches_by_dtype']} for "
              f"{steps} steps, expected bfloat16 x {3 * steps}")
    rec["f32_phase7"] = {k: f32_rec[k] for k in ("ms_per_step_median",
                                                 "fps_median")}
    rec["speedup_vs_f32"] = (f32_rec["ms_per_step_median"]
                             / rec["ms_per_step_median"])
    print(json.dumps({"bf16_batch_engine": {
        k: rec[k] for k in ("ms_per_step_median", "fps_median",
                            "f32_phase7", "speedup_vs_f32",
                            "bn_rounding")}}), flush=True)
    return rec, k1


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "tiny_usot_w8c32.msgpack")


def _carry_to(state, device):
    """A copy of an engine carry on `device`."""
    def move(t):
        return tuple(move(u) for u in t) if isinstance(t, tuple) \
            else t.to(device, copy=True)
    return type(state)(*[move(f) for f in state])


def run_fixture(device, n_frames=21, box=48, size=320):
    """The trained w8c32 fixture, read by the port's msgpack reader
    (`tests/fixtures/tiny_usot_w8c32.msgpack`), tracked by `ScanEngine`
    on the card in f32 and in bf16 on 20 frames of the 48-px video of
    `tests/test_tracker.py`. Per step, teacher-forced, the card's step
    against the CPU's from the same carry: in f32 within 0.02 px and 1e-4
    in score; in bf16 the card's largest gap to the CPU's bf16 step at
    most the CPU's own f32-vs-bf16 step gap from that carry. Records the
    free-running trajectories' deviations (card vs CPU, f32 vs bf16) and
    their errors against the ground truth. Returns the record."""
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.tracker.engine import ScanEngine
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.train.checkpoint import load_model_state
    from usot_tpu_torch.utils.msgpack import read_msgpack

    meta = read_msgpack(FIXTURE)
    kw = {k: int(meta[k]) for k in ("mem_size", "width", "channels")}
    weights = load_model_state(FIXTURE)
    frames, centers = synthetic_video(n_frames, box, h=size, w=size)
    gt = np.asarray(centers[1:], np.float64)
    p = _tracker_config("small")
    cpu = torch.device("cpu")
    f32, bf16 = torch.float32, torch.bfloat16

    def engine(dev, dtype):
        model = build_usot(fused_xcorr=True, dtype=dtype, **kw)
        runner = ModelRunner(model, weights, device=dev)
        eng = ScanEngine(model, p, size, size, max_frames=8, chunk=8,
                         device=dev)
        return eng, lambda: eng.init_state(
            frames[0], np.array(centers[0], float),
            np.array([box, box], float), runner)

    engines = {(d.type, t): engine(d, t) for d in (device, cpu)
               for t in (f32, bf16)}
    rec, tracks, launches = {"frames": n_frames - 1}, {}, {}
    for (dev, dtype), (eng, init) in engines.items():
        label = f"{dev}_{str(dtype)[6:]}"
        before = launch_dtypes()["K1"]
        _, pos, sz, score = eng.track_frames(init(), np.stack(frames[1:]))
        if dev == "cuda":
            after = launch_dtypes()["K1"]
            launches[label] = {k: after[k] - before.get(k, 0)
                               for k in after}
        _check_track(f"fixture {label}", pos, sz)
        tracks[label] = pos
        rec[f"center_error_vs_gt_{label}"] = float(
            np.linalg.norm(pos - gt, axis=1).mean())

    def deviation(a, b):
        d = np.linalg.norm(tracks[a] - tracks[b], axis=1)
        return {"mean": float(d.mean()), "max": float(d.max())}

    dt = device.type
    rec["deviation_px"] = {
        "card_vs_cpu_f32": deviation(f"{dt}_float32", "cpu_float32"),
        "card_vs_cpu_bf16": deviation(f"{dt}_bfloat16", "cpu_bfloat16"),
        "card_f32_vs_bf16": deviation(f"{dt}_float32", f"{dt}_bfloat16")}

    # teacher-forced: per dtype, from the card's carry frame by frame
    steps = {}
    one = torch.ones(1, dtype=torch.bool)
    for dtype in (f32, bf16):
        card_eng, init = engines[(dt, dtype)]
        same = engines[("cpu", dtype)][0]
        other = engines[("cpu", f32 if dtype == bf16 else bf16)][0]
        carry = init()
        gaps = {"pos": [], "score": [], "own_pos": [], "own_score": []}
        for t in range(1, n_frames):
            frame = torch.from_numpy(frames[t][None])
            _, ref = same.run_chunk(_carry_to(carry, cpu), frame, one)
            _, alt = other.run_chunk(_carry_to(carry, cpu), frame, one)
            carry, out = card_eng.run_chunk(carry, frame.to(device),
                                            one.to(device))
            out = [o.cpu() for o in out]
            gaps["pos"].append(float((out[0] - ref[0]).norm()))
            gaps["score"].append(float((out[2] - ref[2]).abs().max()))
            gaps["own_pos"].append(float((alt[0] - ref[0]).norm()))
            gaps["own_score"].append(float((alt[2] - ref[2]).abs().max()))
        worst = {k: max(v) for k, v in gaps.items()}
        if dtype == f32:
            check(worst["pos"] <= 0.02 and worst["score"] <= 1e-4,
                  f"fixture f32 step, card vs CPU: {worst}")
        else:
            check(worst["pos"] <= worst["own_pos"]
                  and worst["score"] <= worst["own_score"],
                  f"fixture bf16 step, card vs CPU: {worst}")
        steps[str(dtype)[6:]] = worst
    rec["teacher_forced_step_max_gap"] = steps
    rec["k1_launches_free_running"] = launches
    print(json.dumps({"fixture": rec}), flush=True)
    return rec


# -------------------------------------------------------------- protocols

def _leaves(state):
    out = []
    for f in state:
        out += _leaves(f) if isinstance(f, tuple) else [f]
    return out


def _clone(state):
    """A copy of an engine state that shares no storage with it."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    items = [_clone(v) for v in state]
    return type(state)(*items) if hasattr(state, "_fields") else tuple(items)


def _protocol_video(n_frames, h, w, box, seed):
    """A square drifting 2 px right and 1 px down per frame over a fixed
    noise frame (made once, so long videos cost a copy per frame).
    Returns (frames, centres)."""
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    x0, y0 = w // 4 + 7 * seed % 40, h // 3 + 5 * seed % 30
    frames, centres = [], []
    for f in range(n_frames):
        im = base.copy()
        cx, cy = x0 + 2 * f, y0 + f
        im[cy - box // 2:cy + box // 2, cx - box // 2:cx + box // 2] = \
            [200, 170, 60]
        frames.append(im)
        centres.append((cx, cy))
    return frames, centres


def _vot_dataset(lengths, h, w, box, chunk):
    """In-memory VOT videos whose ground truth forces the restarts
    (`tests/test_lockstep.py:154`): a full-frame box always overlaps, a
    box off the canvas never does. Lane 0 fails early in the first chunk
    and restarts in it (a replay), lane 1 fails near its end and
    re-inits in the next chunk, lane 2 fails in the second chunk and
    restarts on a box so small (< 0.4 % of the frame) that the instance
    size flips (a spill). Random weights add failures of their own (the
    boxes degenerate), on which both paths must agree as well. Frames
    are arrays, which `read_image` passes."""
    fails = {0: max(1, chunk // 2 - 5), 1: chunk - 4, 2: chunk + 4}
    small = max(2, int(np.sqrt(0.003 * h * w)))
    dataset = {}
    for v, n in enumerate(lengths):
        frames, centres = _protocol_video(n, h, w, box, seed=v)
        fail = fails.get(v)
        gt = []
        for f, (cx, cy) in enumerate(centres):
            if f == 0 or (fail is not None and f == fail + 5):
                b = small if v == 2 and f else box
                gt.append([cx - b / 2, cy - b / 2, b, b])
            elif f == fail:
                gt.append([w + 50.0, h + 50.0, 20.0, 20.0])
            else:
                gt.append([0.0, 0.0, float(w), float(h)])
        name = f"vot{v}"
        dataset[name] = dict(name=name, image_files=frames,
                             gt=np.asarray(gt))
    return dataset


def _result_kinds(path):
    with open(path) as f:
        return ["bbox" if "," in ln else ln.strip() for ln in f]


def _splice_check(engine, runner, videos, h, w, box, device):
    """After a chunk, splice fresh videos into lanes 1 and 3 with one
    `splice_lanes` and a fresh video into lane 2 with `splice_lane`:
    each spliced lane's carry equals the lane state bitwise, the other
    lanes and the rest of the rings are bitwise untouched."""
    state = engine.init_batch(videos, runner)
    frames = np.stack([np.stack(_protocol_video(engine.chunk + 1, h, w, box,
                                                seed=20)[0][1:])]
                      * engine.batch)
    state, *_ = engine.track_batch(state, frames,
                                   np.full(engine.batch, engine.chunk))
    before = _leaves(_clone(state))
    fresh = [(f[0], np.array(c[0], float), np.array([box, box], float))
             for f, c in (_protocol_video(1, h, w, box, seed=s)
                          for s in (31, 32, 33))]
    many = engine.make_lane_states(fresh[:2], runner)
    one = engine.make_lane_state(*fresh[2], runner)
    state = engine.splice_lanes(state, [1, 3], many)
    state = engine.splice_lane(state, 2, one)
    check(all(torch.equal(a[0], b[0])
              for a, b in zip(_leaves(state), before)),
          "splice: lane 0 changed")
    rings_before = before[11:14]
    for lane, src, i in ((1, many, 0), (3, many, 1), (2, one, 0)):
        pos, sz = ((src["pos"][i], src["sz"][i]) if src is many
                   else (src["pos"], src["sz"]))
        pairs = [(state.pos[lane], torch.as_tensor(pos, device=device)),
                 (state.sz[lane], torch.as_tensor(sz, device=device))]
        pairs += [(t[lane, 0], v[i]) for ts, vs in
                  zip(state.zf_enc, src["zf_enc"]) for t, v in zip(ts, vs)]
        pairs += [(t[lane], f[2 * i:2 * i + 2])
                  for t, f in zip(state.init_enc, src["feat_enc"])]
        pairs += [(r[lane, 0], f[2 * i])
                  for r, f in zip(state.mem_enc, src["feat_enc"])]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"splice: lane {lane} differs from its lane state")
        check(all(torch.equal(r[lane, 1:], b[lane, 1:])
                  for r, b in zip(state.mem_enc, rings_before)),
              f"splice: lane {lane}'s stale ring slots changed")
        check(float(state.mem_conf[lane, 0]) == np.float32(0.9)
              and int(state.mem_idx[lane, 0]) == 0
              and bool((state.mem_idx[lane, 1:] == -1).all())
              and int(state.mem_len[lane]) == 1,
              f"splice: lane {lane}'s ring bookkeeping not reset")
    return state


def _donate_check(engine, runner, videos, h, w, box):
    """run_chunk(donate=False) once every ring is full: the passed state
    is bitwise unchanged and a replay from it gives bitwise the same
    outputs. Returns the chunks run before the checked one."""
    state = engine.init_batch(videos, runner)
    n = 3 * engine.chunk
    lanes = np.stack([np.stack(_protocol_video(n + 1, h, w, box, seed=40)
                               [0][1:])] * engine.batch)
    staged = engine.stage_frames(lanes, np.full(engine.batch, n))
    for _, block, valid in staged[:-1]:
        state, _ = engine.run_chunk(state, block, valid)
    check(int(state.mem_len.min()) > engine.max_frames,
          f"donate check: rings not full ({state.mem_len.tolist()})")
    _, block, valid = staged[-1]
    before = _leaves(_clone(state))
    out_state, outs = engine.run_chunk(state, block, valid, donate=False)
    check(all(torch.equal(a, b) for a, b in zip(_leaves(state), before)),
          "donate=False changed the state it was passed")
    again, outs2 = engine.run_chunk(state, block, valid, donate=False)
    check(all(torch.equal(a, b) for a, b in zip(outs, outs2))
          and all(torch.equal(a, b) for a, b in zip(_leaves(again),
                                                    _leaves(out_state))),
          "a replay from the kept state differs")
    return len(staged) - 1


def _ring_copy(engine, state, device):
    """Bytes of one lane's three rings, and the device ms of the ring
    copies `run_chunk(donate=False)` makes (median of 5; CUDA only)."""
    lane_bytes = sum(r[0].numel() * r.element_size() for r in state.mem_enc)
    if device.type != "cuda":
        return lane_bytes, None
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        copies = [r.clone() for r in state.mem_enc]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del copies
    return lane_bytes, statistics.median(times)


def protocol_datasets(h=480, w=640, box=60, vot_lanes=8, vot_lengths=(40, 64),
                      chunk=16, refill_lengths=(8, 80), refill_videos=10):
    """Phase 9's in-memory videos (its defaults are `run_protocols`'s):
    (VOT videos whose ground truth forces the restarts, the refill
    protocol's OTB-layout videos)."""
    lo, hi = vot_lengths
    lengths = [lo + (hi - lo) * v // max(vot_lanes - 1, 1)
               for v in range(vot_lanes)]
    vot = _vot_dataset(lengths, h, w, box, chunk)
    lo, hi = refill_lengths
    refill = {}
    for v in range(refill_videos):
        n = lo + (hi - lo) * v // max(refill_videos - 1, 1)
        frames, centres = _protocol_video(n, h, w, box, seed=50 + v)
        refill[f"r{v}"] = dict(
            name=f"r{v}", image_files=frames,
            gt=np.asarray([[centres[0][0] - box / 2,
                            centres[0][1] - box / 2, box, box]] * n))
    return vot, refill


def roi_leg(model, runner, p, device, lanes=8, n_frames=64,
            hw=(720, 1280), box=60, chunk=16, accept_frames=8):
    """`track_batch_roi` at `suggest_roi`'s size against `track_batch` on
    the same `lanes` videos of `n_frames` frames at `hw` within 1e-2 px,
    and `accept_frames` one-frame chunks (the first accepted whatever
    the weights do: its anchor is the init position, and
    `suggest_roi(chunk=1)` holds its window). Returns (record with the
    engine's `roi_*` telemetry, K1 launches of the ROI path)."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    rh, rw = hw
    clips = [_protocol_video(n_frames + 1, rh, rw, box, seed=60 + v)
             for v in range(lanes)]
    videos = [(f[0], np.array(c[0], float), np.array([box, box], float))
              for f, c in clips]
    frames = np.stack([np.stack(f[1:]) for f, _ in clips])
    n_valid = np.full(lanes, n_frames)
    engine = BatchScanEngine(model, p, canvas_h=rh, canvas_w=rw,
                             batch=lanes, max_frames=n_frames + 8,
                             chunk=chunk, device=device)
    _, pos_f, sz_f, _ = engine.track_batch(engine.init_batch(videos, runner),
                                           frames, n_valid)
    state = engine.init_batch(videos, runner)
    state_1 = _clone(state)  # a replay consumes the state it starts from
    roi = engine.suggest_roi(state)
    roi_1 = engine.suggest_roi(state, chunk=1)
    engine.warm_roi(state, roi)
    engine.warm_roi(state, roi_1, chunk=1)
    telemetry = ("roi_accepted", "roi_replays", "roi_chunks",
                 "roi_escalations", "roi_final", "roi_fallback",
                 "roi_bytes_sent", "roi_bytes_full_equiv")

    def held(pos, sz, k):
        err = float(max(np.abs(pos - pos_f[:, :k]).max(),
                        np.abs(sz - sz_f[:, :k]).max()))
        check(err <= 1e-2, f"ROI against full frames: {err} px > 1e-2")
        return err

    reset_launch_counts()  # the ROI path starts here
    t0 = time.perf_counter()
    _, pos_r, sz_r, _ = engine.track_batch_roi(state, frames, n_valid,
                                               roi=roi)
    roi_s = time.perf_counter() - t0
    run = {k: getattr(engine, k) for k in telemetry}
    _, pos_1, sz_1, _ = engine.track_batch_roi(
        state_1, frames[:, :accept_frames],
        np.full(lanes, accept_frames), roi=roi_1, chunk=1)
    k1 = launch_counts()["K1"]  # read just after the path
    err = held(pos_r, sz_r, n_frames)
    err_1 = held(pos_1, sz_1, accept_frames)
    check(engine.roi_accepted >= 1,
          f"one-frame ROI chunks: none accepted "
          f"({engine.roi_chunks} dispatched)")
    rec = {
        "lanes": lanes, "canvas": [rh, rw], "frames": int(n_valid.sum()),
        "chunk": chunk,
        "suggested_roi": roi, "max_abs_err_px": err, "seconds": roi_s,
        "fps": int(n_valid.sum()) / roi_s, "k1_launches": k1,
        **run,
        "roi_bytes_per_chunk": lanes * chunk * roi * roi * 3,
        "full_bytes_per_chunk": lanes * chunk * rh * rw * 3,
        "one_frame_chunks": {
            "frames": accept_frames, "suggested_roi": roi_1,
            "max_abs_err_px": err_1,
            **{k: getattr(engine, k) for k in telemetry}}}
    return rec, k1


def run_protocols(model, device, h=480, w=640, box=60, vot_lanes=8,
                  vot_lengths=(40, 64), chunk=16, refill_lanes=4,
                  refill_lengths=(8, 80), refill_videos=10, roi_lanes=8,
                  roi_frames=64, roi_hw=(720, 1280), roi_accept_frames=8,
                  donate_max_frames=8, out_dir=OUT_DIR, card=""):
    """Phase 9: the test CLI's benchmark protocols on the batch engine at
    full width, through the entry points a user calls:
    * VOT restart: `track_dataset_vot_batched` on in-memory VOT videos
      (same-chunk and cross-chunk restarts, a spill), its restart
      skeletons against `--engine scan`'s (`track_video_scan`);
    * lane refill: `track_dataset_batched` with refill, every video
      covered, refills counted; a splice's lanes held bitwise;
    * ROI: `track_batch_roi` at `suggest_roi`'s size against
      `track_batch` on the same frames within 1e-2 px, bytes uploaded
      per chunk. On 1280x720 frames (`roi_hw`), where the suggested
      window is a fifth of a frame. Random weights throw a lane tens of
      px a frame in no steady direction, which a 16-frame window does
      not follow: the first chunk may replay on full frames and the run
      go on full frames. So the
      same lanes also run `roi_accept_frames` one-frame chunks, whose
      first is accepted by construction: crops at a non-zero origin held
      against full frames (accepted chunks read the full-frame crop's
      taps and weights, so the error is 0.0 unless a kernel is not
      deterministic; steady-state byte savings are held on the trained
      fixture by the CPU tests);
    * `run_chunk(donate=False)` with full rings, and the cost of its
      ring copies at the VOT engine's size.
    K1 launches are counted per protocol (the counts set to 0 just
    before each and read just after). Returns (record, K1 launches)."""
    from usot_tpu_torch.cli import test as cli
    from usot_tpu_torch.tracker.engine import BatchScanEngine
    from usot_tpu_torch.tracker.runner import ModelRunner

    runner = ModelRunner(model, device=device)
    root = os.path.join(out_dir, "protocols")
    shutil.rmtree(root, ignore_errors=True)
    k1 = {}
    rec = {"card": card}

    # -- VOT restart, lockstep against the scan engine
    vot, refill = protocol_datasets(h, w, box, vot_lanes, vot_lengths, chunk,
                                    refill_lengths, refill_videos)
    common = ["--dataset", "VOT2018", "--chunk", str(chunk), "--batch",
              str(vot_lanes)]
    args = cli.parse_args(common + ["--result_dir",
                                    os.path.join(root, "batch")])
    reset_launch_counts()  # the VOT protocol's path starts here
    (group,) = cli.track_dataset_vot_batched(model, runner, vot, args)
    k1["vot"] = launch_counts()["K1"]  # read just after the path
    scan_args = cli.parse_args(common + ["--result_dir",
                                         os.path.join(root, "scan")])
    engines = {}
    for name in vot:
        cli.track_video_scan(model, runner, vot[name], scan_args, engines)
    skeletons = {}
    for name in vot:
        rel = os.path.join("VOT2018", "USOT", "baseline", name,
                           name + "_001.txt")
        ours = _result_kinds(os.path.join(root, "batch", rel))
        want = _result_kinds(os.path.join(root, "scan", rel))
        check(ours == want, f"VOT {name}: lockstep rows {ours} != scan "
              f"rows {want}")
        skeletons[name] = "".join("b" if k == "bbox" else k for k in ours)
    check(group["replays"] >= 1 and len(group["spilled"]) == 1,
          f"VOT group: {group['replays']} replays, spilled "
          f"{group['spilled']} (expected >= 1 and one video)")
    rec["vot"] = {**group, "skeletons": skeletons, "k1_launches": k1["vot"]}

    # -- lane refill, and one splice held bitwise
    args = cli.parse_args(["--dataset", "OTB2015", "--engine", "batch",
                           "--refill", "1", "--chunk", str(chunk),
                           "--batch", str(refill_lanes), "--result_dir",
                           os.path.join(root, "refill")])
    reset_launch_counts()  # the refill protocol's path starts here
    (group,) = cli.track_dataset_batched(model, runner, refill, args)
    k1["refill"] = launch_counts()["K1"]  # read just after the path
    check(group["refills"] >= refill_videos - refill_lanes,
          f"refill: {group['refills']} refills")
    for name, video in refill.items():
        with open(os.path.join(root, "refill", "OTB2015", "USOT",
                               name + ".txt")) as f:
            rows = f.read().split()
        check(len(rows) == len(video["image_files"]),
              f"refill: {name} has {len(rows)} rows")
    p = _tracker_config("small")
    init = [(f[0], np.array(c[0], float), np.array([box, box], float))
            for f, c in (_protocol_video(1, h, w, box, seed=s)
                         for s in range(4))]
    engine = BatchScanEngine(model, p, canvas_h=h, canvas_w=w, batch=4,
                             max_frames=64, chunk=4, device=device)
    _splice_check(engine, runner, init, h, w, box, device)
    rec["refill"] = {**group, "k1_launches": k1["refill"],
                     "splice_bitwise": True}

    # -- ROI streaming against full frames
    rec["roi"], k1["roi"] = roi_leg(model, runner, p, device, roi_lanes,
                                    roi_frames, roi_hw, box, chunk,
                                    roi_accept_frames)
    # the ROI leg's first video, which the checks below start from
    f, c = _protocol_video(1, *roi_hw, box, seed=60)
    first = (f[0], np.array(c[0], float), np.array([box, box], float))

    # -- donate=False with full rings; the ring copy at the VOT size
    engine = BatchScanEngine(model, p, canvas_h=h, canvas_w=w,
                             batch=vot_lanes, max_frames=donate_max_frames,
                             chunk=max(4, donate_max_frames // 2),
                             device=device)
    _donate_check(engine, runner, [first] * vot_lanes, h, w, box)
    engine = BatchScanEngine(model, p, canvas_h=h, canvas_w=w,
                             batch=vot_lanes, max_frames=2048, chunk=chunk,
                             device=device)
    lane_bytes, copy_ms = _ring_copy(
        engine, engine.init_batch([first] * vot_lanes, runner), device)
    rec["donate"] = {"bitwise": True, "max_frames": donate_max_frames,
                     "ring_bytes_per_lane_at_2048": lane_bytes,
                     "ring_copy_ms_b8_2048": copy_ms}
    del engine

    # -- what a frame step costs at the protocols' batches (staged chunk,
    # after a warm one): the floor under their frames/s
    rec["step_ms"] = {}
    for b in sorted({vot_lanes, refill_lanes}):
        engine = BatchScanEngine(model, p, canvas_h=h, canvas_w=w, batch=b,
                                 max_frames=4 * chunk, chunk=chunk,
                                 device=device)
        state = engine.init_batch([first] * b, runner)
        staged = engine.stage_frames(
            np.stack([np.stack(_protocol_video(2 * chunk + 1, h, w, box,
                                               seed=70)[0][1:])] * b),
            np.full(b, 2 * chunk))
        state, outs = engine.run_chunk(state, *staged[0][1:])
        outs[0].cpu()
        t0 = time.perf_counter()
        state, outs = engine.run_chunk(state, *staged[1][1:])
        outs[0].cpu()
        rec["step_ms"][f"B={b}"] = (time.perf_counter() - t0) / chunk * 1e3
    del engine

    total = sum(k1.values())
    if device.type == "cuda":
        check(all(n > 0 for n in k1.values()),
              f"protocols: K1 not launched on every path {k1}")
    rec["k1_launches"] = dict(k1, total=total)
    print(json.dumps(rec), flush=True)
    return rec, total


# --------------------------------------------------------------- training

def training_config(out, width, channels, batch, mem, end_epoch=6,
                    memory_epoch=3, unfix_epoch=5):
    """The reference recipe (`experiments/train/USOT.yaml`) with depth cut
    to `end_epoch` epochs: warmup over 2, lambda / cls_ratio shifts at 4
    and 6, the memory phase from `memory_epoch`, unfreezing at
    `unfix_epoch`; logs and checkpoints under `out`."""
    from usot_tpu_torch.config.defaults import load_config

    cfg = load_config(None)
    cfg.OUTPUT_DIR = os.path.join(out, "log")
    cfg.CHECKPOINT_DIR = os.path.join(out, "snapshot")
    cfg.PRINT_FREQ = 1
    tc = cfg.USOT.TRAIN
    tc.WIDTH, tc.CHANNELS = width, channels
    tc.BATCH = tc.BATCH_STAGE_2 = batch
    tc.MEMORY_NUM = mem
    tc.END_EPOCH, tc.MEMORY_EPOCH, tc.UNFIX_EPOCH = \
        end_epoch, memory_epoch, unfix_epoch
    tc.PRETRAIN = "none.pth"
    tc.WARMUP.EPOCH = 2
    tc.LR.KWARGS.end_lr = 0.0001
    tc.LAMBDA_SHIFT_EPOCHS = [0, 4, 6]
    tc.CLS_RATIO_SHIFT_EPOCHS = [0, 4, 6]
    return cfg


def train_args(shards=None, **kw):
    """The trainer's arguments: from the shard set `shards`, or (None)
    from the live loader; `kw` sets others."""
    from usot_tpu_torch.cli.train import parse_args

    args = parse_args([] if shards is None else ["--shards", shards])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _step_batch(samples, device):
    """Collate samples as a shard batch (uint8 channel-flat images) on
    `device`."""
    from usot_tpu_torch.data.shards import _pack_sample

    packed = [_pack_sample(s) for s in samples]
    return {k: torch.from_numpy(np.stack([p[k] for p in packed])).to(device)
            for k in packed[0]}


def _fresh_step(model, state, cycle_memory, unfix, remat=False, accum=1):
    """`model` reset to `state`, a new optimizer and the step of one
    phase (lambda_1 0.3, the recipe's momentum and weight decay)."""
    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    model.load_state_dict(state)
    opt, _ = build_optimizer(model, 0.9, 1e-4, 0.1, unfix)
    return make_train_step(model, opt, cycle_memory, unfix, 0.3,
                           remat=remat, accum_steps=accum)


def _grads_and_stats(model):
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    stats = {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return grads, stats


def training_vs_cpu(model, device, mem, tol=1e-3, loss_tol=1e-4):
    """One step of three programs from the same weights on `device` and
    on the CPU, B=1: naive and cycle memory with the stages frozen, in
    float32 on both; naive with the stages unfrozen in float64 on both.
    Losses within `loss_tol` relative, every gradient and BN running stat
    within `tol` scale-aware (cuDNN's and the CPU's summation orders).
    The unfrozen step in float32 is ill-conditioned (a 1x1 conv into a
    train-mode BN whose input has mean^2/var ~100: the CPU's own float32
    and float64 gradients differ by 1.5-3 % in layer1), so it is also run
    in float32 on the card against the CPU's float64, holding its losses
    and BN stats and recording its gradient gap."""
    cpu = torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    models = {}

    def copy_of(dev, dtype):
        if (dev, dtype) not in models:
            models[dev, dtype] = copy.deepcopy(model).to(dev, dtype)
        return models[dev, dtype]

    state = copy.deepcopy(model.state_dict())
    rng = np.random.default_rng(5)
    samples = {cyc: [training_sample(rng, cyc, mem)] for cyc in (False, True)}
    out = {}
    for label, cyc, unfix, dev_dtype, cpu_dtype, hold_grads in (
            ("naive_frozen", False, False, f32, f32, True),
            ("cycle_frozen", True, False, f32, f32, True),
            ("naive_unfrozen_f64", False, True, f64, f64, True),
            ("naive_unfrozen_f32_vs_cpu_f64", False, True, f32, f64, False)):
        res = {}
        for dev, dtype in ((device, dev_dtype), (cpu, cpu_dtype)):
            m = copy_of(dev, dtype)
            step = _fresh_step(m, state, cyc, unfix)
            met = step(_step_batch(samples[cyc], dev), 0.005, 0.5)
            res[dev.type] = ({k: float(v) for k, v in met.items()},
                             *_grads_and_stats(m))
        (l_dev, g_dev, s_dev), (l_cpu, g_cpu, s_cpu) = \
            res[device.type], res["cpu"]
        check(set(g_dev) == set(g_cpu) and len(g_dev) > 0,
              f"{label}: trainable sets differ")
        rec = {"loss": l_dev, "loss_cpu": l_cpu}
        for k in l_cpu:
            err = abs(l_dev[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
            check(np.isfinite(l_dev[k]) and err <= loss_tol,
                  f"{label} {k}: {l_dev[k]} vs CPU {l_cpu[k]} ({err})")
        for kind, a, b in (("grad", g_dev, g_cpu), ("bn_stat", s_dev, s_cpu)):
            worst = max(((close_scaled(a[n], b[n], tol)[1], n) for n in b))
            rec[f"max_scaled_{kind}_err"] = {"err": worst[0],
                                             "tensor": worst[1]}
            if kind == "bn_stat" or hold_grads:
                check(worst[0] <= tol, f"{label}: {kind} {worst[1]} GPU vs "
                      f"CPU {worst[0]} > {tol}")
        out[label] = rec
    print(json.dumps({"training_gpu_vs_cpu": out}), flush=True)
    return out


def _timed_steps(step, batch, n, device):
    """(median ms of the n steps after the first, peak bytes allocated,
    the first step's loss)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms, losses = [], []
    for _ in range(n + 1):
        sync(device)
        t0 = time.perf_counter()
        met = step(batch, 0.005, 0.5)  # ends in the NaN gate's host sync
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    return statistics.median(ms[1:]), peak, losses[0]


def _profile_breakdown(step, batch, device, top=12):
    """Device ms of one step by category, from `torch.profiler`'s op
    attribution (each kernel's time goes to the op that launched it):
    convolutions forward and backward, the correlation's grouped
    convolutions apart (batch 1, one group per lane and channel), layout
    copies and the rest; BatchNorm's forward (a range around each call:
    its train-mode statistics are elementwise ops) and the SGD step
    (torch's own `Optimizer.step` range) as the kernels inside their
    ranges; and the `top` ops by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from usot_tpu_torch.models.layers import BatchNorm

    plain_bn = BatchNorm.forward

    def ranged(self, x, train=False):
        with record_function("usot::batch_norm"):
            return plain_bn(self, x, train)

    BatchNorm.forward = ranged
    try:
        step(batch, 0.005, 0.5)  # warm
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step(batch, 0.005, 0.5)
            sync(device)
    finally:
        BatchNorm.forward = plain_bn
    cats = {k: 0.0 for k in ("conv_fwd", "conv_bwd", "correlation_fwd",
                             "correlation_bwd", "layout_copies", "other")}
    ranges = {"batch_norm_fwd": 0.0, "optimizer": 0.0}
    ops: dict = {}
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.is_user_annotation:
            if ev.device_type == DeviceType.CPU:
                name = "batch_norm_fwd" if ev.key == "usot::batch_norm" \
                    else "optimizer" if ev.key.startswith("Optimizer.step") \
                    else None
                if name:
                    ranges[name] += ev.device_time_total / 1e3
            continue
        if ev.device_type != DeviceType.CPU:
            continue  # a kernel's own event: its time is its op's already
        own = ev.self_device_time_total / 1e3
        if own == 0.0:
            continue
        ops[ev.key] = ops.get(ev.key, 0.0) + own
        shapes = ev.input_shapes or [[]]
        batch_1 = bool(shapes[0]) and shapes[0][0] == 1
        if "conv" in ev.key:
            kind = "bwd" if "backward" in ev.key else "fwd"
            cats[("correlation_" if batch_1 else "conv_") + kind] += own
        elif ev.key in ("aten::copy_", "aten::contiguous", "aten::clone"):
            cats["layout_copies"] += own
        else:
            cats["other"] += own
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(cats.values()), **cats, **ranges,
            "top_ops_ms": dict(top_ops)}


def check_schedule(record, cfg, iters):
    """The trainer's record of `training_config`'s 6 epochs: each epoch's
    phase, unfreeze, lambda_1, cls_ratio, lr and step count as the
    schedule has them, finite losses, checkpoints of epochs 5 and 6
    only."""
    from usot_tpu_torch.train.schedulers import build_lr_spaces
    from usot_tpu_torch.train.step import epoch_weights

    tc = cfg.USOT.TRAIN
    spaces = build_lr_spaces(tc, tc.END_EPOCH)
    check(sorted(map(int, record["epochs"])) == list(range(1, 7)),
          f"epochs run: {sorted(record['epochs'])}")
    for e in range(1, 7):
        r = record["epochs"][str(e)]
        l1, _, ratio = epoch_weights(tc, e)
        want = {"cycle_memory": e >= 3, "unfix": e >= 5,
                "lambda_1": l1, "cls_ratio": ratio, "n_iters": iters,
                "lr": float(spaces[e - 1])}
        got = {k: r[k] for k in want}
        check(got == want, f"epoch {e}: record {got}, expected {want}")
        check(all(np.isfinite(r["losses"])), f"epoch {e}: {r['losses']}")
    saved = sorted(os.listdir(cfg.CHECKPOINT_DIR))
    check(saved == ["checkpoint_e5.pth", "checkpoint_e6.pth"],
          f"checkpoints: {saved}")


def run_training(device, width=64, channels=256, batch=12, mem=4, iters=2,
                 timing_steps=3, out_dir=None):
    """Phase 10: the trainer (`usot_tpu_torch.cli.train.train`) through
    the staged schedule on a synthetic shard set, its resume, the step on
    the card against the CPU and the step's times. Returns (record,
    kernel launches on the training path)."""
    import tempfile

    from usot_tpu_torch.cli.train import train
    from usot_tpu_torch.models.usot import build_usot, init_model

    rec = {"width": width, "channels": channels, "batch": batch,
           "memory_frames": mem}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        shards = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        rec["shard_bytes"] = write_training_shards(
            shards, 6, 3, iters * batch, mem)
        rec["shard_write_s"] = time.perf_counter() - t0
        cfg = training_config(os.path.join(tmp, "full"), width, channels,
                              batch, mem)
        reset_launch_counts()  # the training path starts here
        t0 = time.perf_counter()
        full = train(cfg, train_args(shards), device)
        rec["schedule_s"] = time.perf_counter() - t0
        launches = launch_counts()  # read just after the path
        check(all(n == 0 for n in launches.values()),
              f"training launched a correlation kernel: {launches}")
        check_schedule(full, cfg, iters)
        snap = cfg.CHECKPOINT_DIR
        rec["losses"] = {e: r["losses"] for e, r in full["epochs"].items()}
        rec["epoch_s"] = {e: r["seconds"] for e, r in full["epochs"].items()}

        resumed = train(
            training_config(os.path.join(tmp, "resumed"), width, channels,
                            batch, mem),
            train_args(shards,
                       resume=os.path.join(snap, "checkpoint_e5.pth")),
            device)
        a = np.array(full["epochs"]["6"]["losses"])
        b = np.array(resumed["epochs"]["6"]["losses"])
        delta = float(np.max(np.abs(a - b) / np.abs(a)))
        check(sorted(resumed["epochs"]) == ["6"] and delta <= 1e-3,
              f"resume: epoch-6 losses {b} vs unbroken {a} ({delta})")
        rec["resume_max_rel_loss_delta"] = delta
        print(json.dumps({"training_schedule": rec}), flush=True)

    model = build_usot(mem_size=mem, width=width, channels=channels)
    init_model(model, torch.Generator().manual_seed(0), device=device)
    rec["gpu_vs_cpu"] = training_vs_cpu(model, device, mem)

    state = copy.deepcopy(model.state_dict())
    rng = np.random.default_rng(6)
    batches = {cyc: _step_batch([training_sample(rng, cyc, mem)
                                 for _ in range(batch)], device)
               for cyc in (False, True)}
    times = {}
    for label, cyc, unfix, kw in (
            ("naive_frozen", False, False, {}),
            ("naive_unfrozen", False, True, {}),
            ("cycle_frozen", True, False, {}),
            ("cycle_unfrozen", True, True, {}),
            ("cycle_unfrozen_remat", True, True, {"remat": True}),
            ("cycle_unfrozen_accum2", True, True, {"accum": 2})):
        step = _fresh_step(model, state, cyc, unfix, **kw)
        ms, peak, loss = _timed_steps(step, batches[cyc], timing_steps,
                                      device)
        times[label] = {"ms_per_step": ms, "samples_per_s": batch * 1e3 / ms,
                        "peak_bytes": peak, "first_loss": loss}
        print(json.dumps({label: times[label]}), flush=True)
    plain, remat = times["cycle_unfrozen"], times["cycle_unfrozen_remat"]
    gap = abs(remat["first_loss"] - plain["first_loss"]) \
        / abs(plain["first_loss"])
    check(gap <= 1e-5, f"remat loss {remat['first_loss']} vs "
          f"{plain['first_loss']}")
    if device.type == "cuda":
        check(remat["peak_bytes"] < plain["peak_bytes"],
              f"remat peak {remat['peak_bytes']} >= {plain['peak_bytes']}")
    rec["steps"] = times
    if device.type == "cuda":
        rec["profile_cycle_unfrozen"] = _profile_breakdown(
            _fresh_step(model, state, True, True), batches[True], device)
        print(json.dumps({"profile_cycle_unfrozen":
                          rec["profile_cycle_unfrozen"]}), flush=True)
    return rec, launches


# ------------------------------------------------- bf16, the live loader

def _bf16_fresh_step(kw, state, device, cycle_memory, unfix):
    """`_fresh_step` on a bf16 model (`build_usot(**kw)`, float32
    parameters) on `device`, loaded with `state`."""
    from usot_tpu_torch.models.usot import build_usot

    bf = build_usot(dtype=torch.bfloat16, **kw).to(device)
    return bf, _fresh_step(bf, state, cycle_memory, unfix)


def _flat(arrays):
    return np.concatenate([np.ravel(x) for x in arrays]).astype(np.float64)


def _rel_rms(a, b):
    a, b = _flat(a), _flat(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _stage_of(name):
    """The part of the model a parameter trains with: a backbone stage
    (`features.features.layerN`), the neck or the head."""
    parts = name.split(".")
    return ".".join(parts[:3]) if parts[0] == "features" else parts[0]


def _cosine(a, b):
    """Cosine between two gradients (lists of arrays); 0 if either is
    zero."""
    a, b = _flat(a), _flat(b)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)) if na and nb else 0.0


def _loss_terms(m, samples, unfix, device):
    """The naive phase's loss terms (cls_loss_ori, reg_loss) of
    `m.forward_train` on each sample alone, without a step."""
    from usot_tpu_torch.train.step import images_f32

    dtype = next(m.parameters()).dtype
    out = []
    with torch.no_grad():
        for s in samples:
            b = _step_batch([s], device)
            img = {k: images_f32(b[k]).to(dtype)
                   for k in ("template", "search")}
            l_ori, _, l_reg = m.forward_train(
                img["template"], img["search"], b["label"],
                b["reg_target"], b["reg_weight"], b["template_bbox"],
                stage_bn_train=unfix)
            out += [float(l_ori), float(l_reg)]
    return out


def bf16_training_vs_cpu(kw, state, device, margin=2.0, accuracy=1.25,
                         loss_samples=12):
    """One bf16 step of three programs from the same weights on `device`
    and on the CPU, B=1 (naive and cycle memory frozen, naive unfrozen),
    with the CPU's float32 step beside them. Relative RMS gaps over the
    losses, the gradients and the BN running stats:

    - agreement: the card's bf16 within `margin` times the CPU's own
      float32-vs-bf16 gap of the CPU's bf16. Two bf16 routes that round
      at the same points but sum in other orders carry independent
      rounding noise of about that gap each;
    - accuracy: the card's bf16 no further from the CPU's float32 than
      `accuracy` times the CPU's bf16 is, for the gradients and the BN
      stats (10^4 values and more). The step's losses are one number in
      effect (the reg loss carries ~99 % of their norm), too few for
      a ratio of two rounding errors to be held at 1.25; they are held
      over `loss_samples` samples instead, each alone through the naive
      forward (no argmax: the memory loss's argmax over bf16 maps flips
      on a one-ulp difference), frozen and unfrozen, at `margin`;
    - direction: over each stage's trainable parameters (`_stage_of`),
      the card's bf16 gradient has 0.5-2x the norm of the CPU's bf16
      one and a positive cosine to the CPU's float32 one, at least half
      the CPU bf16's where that is 0.5 or more. bf16 gradients at B=1
      are noisy (relative RMS 0.2-1.4 from float32); in the unfrozen
      stages they are mostly rounding noise (cosine 0.06-0.14 at full
      width, 0.09-0.21 at w8c32: train-mode BN's backward cancels most
      of the bf16-rounded gradient it receives), so two bf16 routes'
      cosines there scatter apart. A gap limit alone would pass a zero
      gradient (relative RMS 1); a zero gradient fails the norm, a
      sign-flipped one the cosine."""
    from usot_tpu_torch.models.usot import build_usot

    cpu = torch.device("cpu")
    mem = kw["mem_size"]
    rng = np.random.default_rng(7)
    samples = {cyc: [training_sample(rng, cyc, mem)] for cyc in (False, True)}
    extra = [training_sample(rng, False, mem) for _ in range(loss_samples)]
    programs = (("card_bf16", device, torch.bfloat16),
                ("cpu_bf16", cpu, torch.bfloat16),
                ("cpu_f32", cpu, torch.float32))
    out, failed = {}, []

    def hold(label, part, gaps, acc=accuracy):
        if not (np.isfinite(gaps["card_vs_cpu_bf16"])
                and gaps["card_vs_cpu_bf16"]
                <= margin * gaps["cpu_f32_vs_bf16"]):
            failed.append((label, part, "agreement", gaps))
        if acc is not None and not (gaps["card_bf16_vs_cpu_f32"]
                                    <= acc * gaps["cpu_f32_vs_bf16"]):
            failed.append((label, part, "accuracy", gaps))

    for label, cyc, unfix in (("naive_frozen", False, False),
                              ("cycle_frozen", True, False),
                              ("naive_unfrozen", False, True)):
        res = {}
        for tag, dev, dtype in programs:
            m = build_usot(dtype=dtype, **kw).to(dev)
            step = _fresh_step(m, state, cyc, unfix)
            t0 = time.perf_counter()
            met = step(_step_batch(samples[cyc], dev), 0.005, 0.5)
            sync(dev)
            secs = time.perf_counter() - t0
            grads, stats = _grads_and_stats(m)
            res[tag] = {"losses": [float(met[k]) for k in sorted(met)],
                        "grads": {n: g.numpy() for n, g in grads.items()},
                        "stats": [stats[n].numpy() for n in sorted(stats)],
                        "s": secs}
            if not cyc:
                m.load_state_dict(state)
                t0 = time.perf_counter()
                res[tag]["loss_terms"] = _loss_terms(m, extra, unfix, dev)
                res[tag]["loss_terms_s"] = time.perf_counter() - t0
        rec = {f"{tag}_s": r["s"] for tag, r in res.items()}
        rec["loss"] = {t: r["losses"] for t, r in res.items()}
        names = sorted(res["cpu_f32"]["grads"])
        for r in res.values():
            r["grads"] = [r["grads"][n] for n in names]
        parts = ["losses", "grads", "stats"] + (["loss_terms"] if not cyc
                                                else [])
        for part in parts:
            card, cb, cf = (res[t][part] for t in ("card_bf16", "cpu_bf16",
                                                   "cpu_f32"))
            gaps = {"card_vs_cpu_bf16": _rel_rms(card, cb),
                    "cpu_f32_vs_bf16": _rel_rms(cf, cb),
                    "card_bf16_vs_cpu_f32": _rel_rms(card, cf)}
            gaps["accuracy_ratio"] = gaps["card_bf16_vs_cpu_f32"] \
                / max(gaps["cpu_f32_vs_bf16"], 1e-30)
            rec[part] = gaps
            hold(label, part, gaps, {"losses": None,
                                     "loss_terms": margin}.get(part,
                                                               accuracy))
        if not cyc:
            rec["loss_terms_s"] = {t: r["loss_terms_s"]
                                   for t, r in res.items()}
        cos = {}
        for stage in sorted({_stage_of(n) for n in names}):
            idx = [i for i, n in enumerate(names) if _stage_of(n) == stage]
            card, cb, cf = ([res[t]["grads"][i] for i in idx]
                            for t in ("card_bf16", "cpu_bf16", "cpu_f32"))
            c = cos[stage] = {
                "card_bf16": _cosine(card, cf), "cpu_bf16": _cosine(cb, cf),
                "norm_ratio": np.linalg.norm(_flat(card))
                / max(np.linalg.norm(_flat(cb)), 1e-30)}
            floor = 0.5 * c["cpu_bf16"] if c["cpu_bf16"] >= 0.5 else 0.0
            if not (c["card_bf16"] > floor
                    and 0.5 <= c["norm_ratio"] <= 2.0):
                failed.append((label, stage, "direction", c))
        rec["grad_cosine_to_cpu_f32"] = cos
        out[label] = rec
    print(json.dumps({"training_bf16_gpu_vs_cpu": out}), flush=True)
    check(not failed, f"bf16 training, the card against the CPU: {failed}")
    return out


def live_loader_rates(cfg, reader, batch, workers, n_batches=4):
    """Samples per second of the live loader alone (`DataLoader` over
    `USOTDataset`, host only), naive and cycle memory, at 1 and
    `workers` threads, over `n_batches` batches: the wait for the first
    (an epoch's cold start: the threads' first calls) apart from the
    rate of the rest."""
    from usot_tpu_torch.data.dataset import USOTDataset
    from usot_tpu_torch.data.loader import DataLoader

    cfg = copy.deepcopy(cfg)
    cfg.USOT.DATASET.GOT10K.USE = n_batches * batch
    out = {}
    for cyc in (False, True):
        for n in sorted({1, workers}):
            ds = USOTDataset(cfg, seed=1, reader=reader)
            ds.cycle_memory = cyc
            stamps = [time.perf_counter()]
            for _ in DataLoader(ds, batch, num_workers=n):
                stamps.append(time.perf_counter())
            check(len(stamps) == n_batches + 1, f"loader: {len(stamps)}")
            key = f"{'cycle' if cyc else 'naive'}_workers_{n}"
            out[key] = {"first_batch_s": stamps[1] - stamps[0],
                        "samples_per_s": (n_batches - 1) * batch
                        / (stamps[-1] - stamps[1])}
    print(json.dumps({"live_loader": out}), flush=True)
    return out


def pipelined_steps(kw, state, cfg, reader, device, batch, workers,
                    n_steps=8, warm_batch=None):
    """The trainer's inner loop on the bf16 cycle-memory unfrozen step:
    the live loader (`workers` threads) through `device_prefetch` into
    the step. The step is warmed on `warm_batch` first, the timing
    starts once the prefetch queue has filled, and the dataset holds
    more batches than the timed `n_steps` take, so the loader works
    through every timed step as it does through an epoch. Returns host
    ms per step, the step's wait for the next batch, and samples/s."""
    from usot_tpu_torch.data.dataset import USOTDataset
    from usot_tpu_torch.data.loader import DataLoader
    from usot_tpu_torch.data.shards import device_prefetch

    bf, step = _bf16_fresh_step(kw, state, device, True, True)
    if warm_batch is not None:
        for _ in range(2):
            step(warm_batch, 0.005, 0.5)
        sync(device)
    cfg = copy.deepcopy(cfg)
    cfg.USOT.DATASET.GOT10K.USE = (n_steps + 6) * batch
    ds = USOTDataset(cfg, seed=2, reader=reader)
    ds.cycle_memory = True
    batches = device_prefetch(DataLoader(ds, batch, num_workers=workers),
                              device)
    t0 = time.perf_counter()
    b = next(batches)  # fills the prefetch queue
    first = time.perf_counter() - t0
    waits, ms = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        if i:
            b = next(batches)
        t1 = time.perf_counter()
        step(b, 0.005, 0.5)  # ends in the NaN gate's host sync
        sync(device)
        waits.append((t1 - t0) * 1e3)
        ms.append((time.perf_counter() - t0) * 1e3)
    batches.close()
    del bf
    return {"first_batches_s": first,
            "ms_per_step": statistics.median(ms),
            "samples_per_s": batch * 1e3 / statistics.median(ms),
            "loader_wait_ms": statistics.median(waits),
            "ms_all": ms, "loader_wait_all": waits}


def run_training_bf16(device, width=64, channels=256, batch=12, mem=4,
                      iters=2, workers=None, timing_steps=3, f32_steps=None,
                      n_videos=24, pipe_steps=4, out_dir=None):
    """Phase 12: the trainer's default path (`cli.train.train` with no
    shard set) in bf16 on `tools/train_synthetic.py`'s dataset made in
    memory (`n_videos` videos of 12 frames, read through the dataset's
    reader), `workers` loader threads (default: the host's cores up to
    8): the staged schedule, its resume, three bf16 steps against the
    CPU, the bf16 steps' times beside phase 10's float32 ones
    (`f32_steps`), the live loader's rates alone and pipelined into the
    step. Returns (record, kernel launches on the training path)."""
    import tempfile

    from usot_tpu_torch.cli.train import train
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.tools.synthetic_crop511 import (gen_dataset,
                                                        use_dataset)

    workers = workers or min(8, os.cpu_count() or 1)
    rec = {"width": width, "channels": channels, "batch": batch,
           "memory_frames": mem, "workers": workers, "dtype": "bfloat16"}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        t0 = time.perf_counter()
        crop_dir, ann_path, reader = gen_dataset(tmp, n_videos=n_videos)
        rec["data_s"] = time.perf_counter() - t0

        def config(tag):
            cfg = training_config(os.path.join(tmp, tag), width, channels,
                                  batch, mem)
            cfg.WORKERS = workers
            return use_dataset(cfg, crop_dir, ann_path, iters * batch)

        cfg = config("full")
        reset_launch_counts()  # the bf16 training path starts here
        t0 = time.perf_counter()
        full = train(cfg, train_args(dtype="bfloat16"),
                     device, reader=reader)
        rec["schedule_s"] = time.perf_counter() - t0
        launches = launch_counts()  # read just after the path
        check(all(n == 0 for n in launches.values()),
              f"bf16 training launched a correlation kernel: {launches}")
        check(full["dtype"] == "bfloat16", f"record dtype {full['dtype']}")
        check_schedule(full, cfg, iters)
        rec["losses"] = {e: r["losses"] for e, r in full["epochs"].items()}
        rec["epoch_s"] = {e: r["seconds"] for e, r in full["epochs"].items()}

        resumed = train(config("resumed"), train_args(
            dtype="bfloat16", resume=os.path.join(
                cfg.CHECKPOINT_DIR, "checkpoint_e5.pth")),
            device, reader=reader)
        a = np.array(full["epochs"]["6"]["losses"])
        b = np.array(resumed["epochs"]["6"]["losses"])
        delta = float(np.max(np.abs(a - b) / np.abs(a)))
        # bf16's ulp is 2^-8: a nondeterministic sum that rounds apart in
        # the first step moves the second one's loss by ~1e-3
        check(sorted(resumed["epochs"]) == ["6"] and delta <= 1e-2,
              f"bf16 resume: epoch-6 losses {b} vs unbroken {a} ({delta})")
        rec["resume_max_rel_loss_delta"] = delta
        print(json.dumps({"training_bf16_schedule": rec}), flush=True)

        kw = {"mem_size": mem, "width": width, "channels": channels}
        model = build_usot(**kw)  # phase 10's weights
        init_model(model, torch.Generator().manual_seed(0), device=device)
        state = copy.deepcopy(model.state_dict())
        del model
        rec["gpu_vs_cpu"] = bf16_training_vs_cpu(kw, state, device)

        rng = np.random.default_rng(6)  # phase 10's batches
        batches = {cyc: _step_batch([training_sample(rng, cyc, mem)
                                     for _ in range(batch)], device)
                   for cyc in (False, True)}
        times = {}
        for label, cyc, unfix in (("naive_frozen", False, False),
                                  ("naive_unfrozen", False, True),
                                  ("cycle_frozen", True, False),
                                  ("cycle_unfrozen", True, True)):
            bf, step = _bf16_fresh_step(kw, state, device, cyc, unfix)
            ms, peak, loss = _timed_steps(step, batches[cyc], timing_steps,
                                          device)
            times[label] = {"ms_per_step": ms,
                            "samples_per_s": batch * 1e3 / ms,
                            "peak_bytes": peak, "first_loss": loss}
            if f32_steps and label in f32_steps:
                times[label]["f32_ms_per_step"] = \
                    f32_steps[label]["ms_per_step"]
                times[label]["f32_peak_bytes"] = f32_steps[label]["peak_bytes"]
            check(np.isfinite(loss), f"bf16 {label}: loss {loss}")
            print(json.dumps({f"bf16_{label}": times[label]}), flush=True)
            del bf, step
        rec["steps"] = times
        if device.type == "cuda":
            bf, step = _bf16_fresh_step(kw, state, device, True, True)
            rec["profile_cycle_unfrozen"] = _profile_breakdown(
                step, batches[True], device)
            print(json.dumps({"profile_bf16_cycle_unfrozen":
                              rec["profile_cycle_unfrozen"]}), flush=True)
            del bf, step
        rec["live_loader"] = live_loader_rates(cfg, reader, batch, workers)
        pipe = pipelined_steps(kw, state, cfg, reader, device, batch,
                               workers, pipe_steps, batches[True])
        step_ms = times["cycle_unfrozen"]["ms_per_step"]
        pipe["step_alone_ms"] = step_ms
        pipe["loader_keeps_up"] = bool(pipe["ms_per_step"]
                                       <= 1.1 * step_ms)
        if "profile_cycle_unfrozen" in rec:
            busy = rec["profile_cycle_unfrozen"]["device_ms"]
            pipe["device_busy_ms"] = busy
            pipe["idle_share"] = max(0.0, 1.0 - busy / pipe["ms_per_step"])
            pipe["idle_share_step_alone"] = max(0.0, 1.0 - busy / step_ms)
        rec["pipelined"] = pipe
        print(json.dumps({"live_loader_pipelined": pipe}), flush=True)
        del batches
    return rec, launches


# ------------------------------------------------------ pseudo-label mining

def mining_video(n_frames, h=720, w=1280, seed=13):
    """A seeded BGR uint8 video for the flow network: a textured object
    (a fifth of the frame a side) moving right and down (~w/140, ~h/180
    px per frame) over a textured background panning left 2 px per
    frame. Textures: uniform noise at 1/16 size upsampled bilinearly,
    plus grain."""
    g = torch.Generator().manual_seed(seed)

    def texture(hh, ww, lo, span):
        coarse = torch.rand(1, 3, hh // 16 + 2, ww // 16 + 2, generator=g)
        smooth = F.interpolate(coarse, size=(hh, ww), mode="bilinear",
                               align_corners=False)[0].permute(1, 2, 0)
        return lo + span * smooth + 30 * torch.rand(hh, ww, 3, generator=g)

    pan = 2
    bg = texture(h, w + pan * n_frames, 20, 150)
    oh, ow = h // 5, w // 5
    obj = texture(oh, ow, 60, 170)
    frames = []
    for f in range(n_frames):
        im = bg[:, pan * f:pan * f + w].clone()
        y, x = int(h / 4 + f * h / 180), int(w / 8 + f * w / 140)
        im[y:y + oh, x:x + ow] = obj
        frames.append(np.ascontiguousarray(
            im.clamp(0, 255).to(torch.uint8).numpy()))
    return frames


def conv_gflop(model, x):
    """GFLOP of the convolutions of one forward of `model` on `x` (2 x
    output elements x input channels per group x taps), by stage."""
    flops: dict = {}

    def hook(name):
        def count(mod, inputs, out):
            taps = mod.kernel_size[0] * mod.kernel_size[1]
            flops[name] = flops.get(name, 0.0) + 2.0 * out.numel() * (
                mod.in_channels // mod.groups) * taps / 1e9
        return count

    handles = [m.register_forward_hook(hook(n.split(".")[0]))
               for n, m in model.named_modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for handle in handles:
            handle.remove()
    return {"total": sum(flops.values()), **flops}


def _flow_profile(helper, pre, triple, device):
    """Device ms of one 3-frame forward by category, from `torch.profiler`
    (each kernel's time goes to the op that launched it): convolutions,
    the cost volumes, the warps and the flow resizes (ranges around
    `pwclite`'s functions), the rest; and the device launches (kernels,
    copies and fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from usot_tpu_torch.preprocessing import pwclite

    names = ("correlation", "flow_warp", "resize_flow")
    plain = {n: getattr(pwclite, n) for n in names}

    def ranged(name):
        def call(*args, **kwargs):
            with record_function("pwc::" + name):
                return plain[name](*args, **kwargs)
        return call

    for n in names:
        setattr(pwclite, n, ranged(n))
    try:
        helper.forward(pre, *triple)  # warm
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            helper.forward(pre, *triple)
            sync(device)
    finally:
        for n, fn in plain.items():
            setattr(pwclite, n, fn)
    ranges = dict.fromkeys(names, 0.0)
    conv = total = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.is_user_annotation:
            if ev.device_type == DeviceType.CPU and ev.key.startswith("pwc::"):
                ranges[ev.key[5:]] += ev.device_time_total / 1e3
            continue
        if ev.device_type != DeviceType.CPU:
            launches += ev.count  # a kernel's own event
            continue
        own = ev.self_device_time_total / 1e3
        total += own
        if "conv" in ev.key:
            conv += own
    return {"device_ms": total, "convolutions": conv,
            "cost_volume": ranges["correlation"],
            "warp": ranges["flow_warp"], "resize": ranges["resize_flow"],
            "other": total - conv - sum(ranges.values()),
            "device_launches": launches}


def _box_check(card_flow, cpu_flow):
    """`flow_to_bbox`'s discrete decisions on the card's flow against the
    CPU's: the distance maps' gap, each group's mask disagreement, whether
    every pixel that flips lies within the gap of the CPU's threshold,
    the saliency test's margin; the boxes, held equal where nothing
    flipped."""
    from usot_tpu_torch.preprocessing import flow2box

    d_card, mean_card, max_card = flow2box.distance_map(card_flow)
    d_cpu, mean_cpu, max_cpu = flow2box.distance_map(cpu_flow)
    gap = float(np.abs(d_card - d_cpu).max())
    same = (np.argmax(d_card) == np.argmax(d_cpu)) and (
        (mean_card < 0.05 or max_card / mean_card > flow2box.SALIENCY)
        == (mean_cpu < 0.05 or max_cpu / mean_cpu > flow2box.SALIENCY))
    flips, explained, margin = [], True, np.inf
    for ratio, _ in flow2box.GROUPS:
        thr_card = ratio * mean_card + (1 - ratio) * max_card
        thr_cpu = ratio * mean_cpu + (1 - ratio) * max_cpu
        flip = (d_card >= thr_card) != (d_cpu >= thr_cpu)
        flips.append(int(flip.sum()))
        near = np.abs(d_cpu - thr_cpu)
        explained &= bool(np.all(near[flip] <= gap + abs(thr_card - thr_cpu)))
        margin = min(margin, float(near.min()))
    boxes_card = flow2box.flow_to_bbox(card_flow)
    boxes_cpu = flow2box.flow_to_bbox(cpu_flow)
    held = same and not any(flips)
    check(explained, f"flow_to_bbox: a pixel flips its mask beyond the "
          f"flow gap {gap}")
    check(not held or boxes_card == boxes_cpu,
          f"flow_to_bbox: equal masks, boxes {boxes_card} vs {boxes_cpu}")
    dev = None
    if len(boxes_card) == len(boxes_cpu) and boxes_card:
        dev = float(np.abs(np.subtract(boxes_card, boxes_cpu)).max())
    return {"distance_gap": gap, "threshold_margin": margin,
            "mask_flips": flips, "held_equal": held,
            "equal": boxes_card == boxes_cpu, "box_max_dev_px": dev,
            "boxes": boxes_card}


def mining_vs_cpu(helper, cpu, frames, decisions, kept_boxes):
    """The card's adaptive loop teacher-forced on the CPU: each forward
    the card made, on the same frames (preprocessed on each device), its
    max|flow| and full-size flow against the CPU's; the CPU's own interval
    decision equal to the card's wherever its margin from 8 or 16 px
    exceeds the gap; the kept flows' candidate boxes (`_box_check`) and
    the card's own run's boxes reproduced."""
    from usot_tpu_torch.preprocessing import inference
    from usot_tpu_torch.preprocessing.pwclite import resize_flow

    h, w = frames[0].shape[:2]
    n = len(frames)
    pre_card = [helper.preprocess(f[..., ::-1]) for f in frames]
    pre_cpu = [cpu.preprocess(f[..., ::-1]) for f in frames]
    pre_err = max(close_scaled(a, b, 1e-3)[1]
                  for a, b in zip(pre_card[:4], pre_cpu[:4]))
    check(pre_err <= 1e-3, f"preprocess card vs CPU: {pre_err}")
    steps, boxes = [], []
    held = 0
    direction, last_i = 0, None
    for i, adjacent, card_max in decisions:
        if i != last_i:
            direction, last_i = 0, i
        triple = (max(0, i - adjacent), i, min(i + adjacent, n - 1))
        fl_card = resize_flow(helper.forward(pre_card, *triple), h, w)
        fl_cpu = resize_flow(cpu.forward(pre_cpu, *triple), h, w)
        ok, err = close_scaled(fl_card, fl_cpu, 1e-3)
        check(ok, f"flow card vs CPU at {triple}: {err}")
        cpu_max = float(fl_cpu.abs().amax())
        flow_gap = float((fl_card.cpu() - fl_cpu).abs().max())
        gap = max(abs(card_max - cpu_max), flow_gap)
        margin = min(abs(cpu_max - inference.SHRINK_ABOVE),
                     abs(cpu_max - inference.GROW_BELOW))
        card_step = inference.next_interval(card_max, adjacent, direction)
        cpu_step = inference.next_interval(cpu_max, adjacent, direction)
        if margin > gap:
            check(card_step == cpu_step, f"interval decision at {triple}: "
                  f"card {card_step} ({card_max}) vs CPU {cpu_step} "
                  f"({cpu_max}), margin {margin} > gap {gap}")
            held += 1
        steps.append({"triple": triple, "card_max": card_max,
                      "cpu_max": cpu_max, "flow_gap": flow_gap,
                      "margin": margin, "scaled_err": err,
                      "equal": card_step == cpu_step})
        if card_step is not None:
            direction = card_step[1]
            continue
        rec = _box_check(fl_card[0].permute(1, 2, 0).cpu().numpy(),
                         fl_cpu[0].permute(1, 2, 0).numpy())
        rec["reproduces_run"] = rec.pop("boxes") == kept_boxes[len(boxes)]
        boxes.append(rec)
    check(len(boxes) == len(kept_boxes), "kept flows: "
          f"{len(boxes)} vs {len(kept_boxes)} sampled frames")
    return {"preprocess_scaled_err": pre_err, "decisions": steps,
            "decisions_held": held, "boxes": boxes,
            "min_margin_px": min(s["margin"] for s in steps),
            "max_flow_gap_px": max(s["flow_gap"] for s in steps),
            "max_scaled_err": max(s["scaled_err"] for s in steps)}


def run_pseudo_labels(device, n_frames=48, h=720, w=1280,
                      test_shape=(384, 640), instance_size=511, card=""):
    """Phase 13: pseudo-label mining through `cli.parse_flow`'s functions
    on a seeded synthetic video held in memory: `inference_sequence`
    (PWCLite in 3-frame mode at `test_shape`, `init_pwclite` weights from
    a fixed generator, the adaptive interval, flow_to_bbox, the DP), the
    crops (`crop_video_frames` at `instance_size`, an in-memory writer)
    and train.json (`build_train_json(quality_gate=False)`, the CLI's
    `--keep_all`); held against a CPU run of the same loop
    (`mining_vs_cpu`), with the forward's times, launches and profile and
    the host's ms per frame. Returns (record, correlation-kernel
    launches on this path)."""
    import tempfile

    from usot_tpu_torch.cli.parse_flow import video_record
    from usot_tpu_torch.preprocessing import inference
    from usot_tpu_torch.preprocessing.crop_gen import (build_train_json,
                                                       crop_video_frames)
    from usot_tpu_torch.preprocessing.pwclite import resize_flow

    rec = {"card": card, "frames": n_frames, "frame_hw": [h, w],
           "test_shape": list(test_shape), "instance_size": instance_size}
    frames = mining_video(n_frames, h, w)
    helper = inference.FlowHelper(test_shape=test_shape, device=device,
                                  generator=torch.Generator().manual_seed(13))
    cpu = inference.FlowHelper(
        {k: v.cpu() for k, v in helper.model.state_dict().items()},
        test_shape=test_shape, device="cpu")

    def mine(tmp):
        """One video through the CLI's functions, each stage on the host
        clock: (results, seconds by stage)."""
        timers = {"preprocess": [], "flow_to_bbox": [], "smooth_bbox_dp": []}
        out = {"kept_boxes": [], "decisions": [], "crops": {}}
        plain = {"preprocess": helper.preprocess,
                 "flow_to_bbox": inference.flow_to_bbox,
                 "smooth_bbox_dp": inference.smooth_bbox_dp}

        def timed(name):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                res = plain[name](*args, **kwargs)
                timers[name].append(time.perf_counter() - t0)
                if name == "flow_to_bbox":
                    out["kept_boxes"].append(res)
                return res
            return call

        helper.preprocess = timed("preprocess")
        inference.flow_to_bbox = timed("flow_to_bbox")
        inference.smooth_bbox_dp = timed("smooth_bbox_dp")
        try:
            sync(device)
            t0 = time.perf_counter()
            out["mined"] = inference.inference_sequence(
                helper, list(range(n_frames)), gap=3, init_adjacent=4,
                rng=np.random.RandomState(13), decisions=out["decisions"],
                reader=frames.__getitem__)
            t_mine = time.perf_counter() - t0
        finally:
            del helper.preprocess  # the class's method again
            inference.flow_to_bbox = plain["flow_to_bbox"]
            inference.smooth_bbox_dp = plain["smooth_bbox_dp"]
        t0 = time.perf_counter()
        crop_video_frames(list(range(n_frames)), out["mined"][0], 0,
                          os.path.join(tmp, "crop511", "video"),
                          instance_size=instance_size,
                          reader=frames.__getitem__,
                          writer=out["crops"].__setitem__)
        t_crop = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = {"video": video_record(out["mined"][0], out["mined"][2],
                                     frames[0].shape)}
        out["train_json"] = json.loads(json.dumps(
            build_train_json(raw, quality_gate=False)))
        t_json = time.perf_counter() - t0
        sec = {k: sum(v) for k, v in timers.items()}
        sec.update({"mine": t_mine, "crop": t_crop, "train_json": t_json,
                    "total": t_mine + t_crop + t_json})
        # the loop's forwards, their syncs and the flows' copies
        sec["flow_loop"] = t_mine - sec["preprocess"] \
            - sec["flow_to_bbox"] - sec["smooth_bbox_dp"]
        return out, sec, {k: len(v) for k, v in timers.items()}

    reset_launch_counts()  # the mining path starts here
    with tempfile.TemporaryDirectory() as tmp:
        _, cold, _ = mine(tmp)  # first use: cuDNN's heuristics per shape
        out, sec, counts = mine(tmp)
    launches = launch_counts()  # read just after the path
    check(all(v == 0 for v in launches.values()),
          f"mining launched a correlation kernel: {launches}")
    boxes, picked, stats = out["mined"]
    decisions, crops, kept_boxes = (out["decisions"], out["crops"],
                                    out["kept_boxes"])
    train_json = out["train_json"]

    sampled = len(range(3, n_frames - 3, 3))
    check(len(boxes) == n_frames and np.all(np.isfinite(boxes)),
          f"mined boxes: {len(boxes)} for {n_frames} frames")
    check(all(1 <= a <= inference.MAX_INTERVAL for _, a, _ in decisions)
          and len({i for i, _, _ in decisions}) == sampled,
          f"decisions {decisions}")
    check(sorted(crops) == [os.path.join(
        tmp, "crop511", "video", f"{i:06d}.00.x.jpg")
        for i in range(n_frames)] and len(kept_boxes) == sampled and all(
        c.shape == (instance_size, instance_size, 3) and c.dtype == np.uint8
        for c in crops.values()), "crops: one per frame, each "
        f"{instance_size}x{instance_size}x3 uint8")
    track = train_json["video"]["00"]
    check(sorted(track) == sorted([str(i) for i in range(n_frames)]
                                  + ["meta"]), "train.json frames")
    check(all(len(track[str(i)]) == 9
              and track[str(i)][6] <= i <= track[str(i)][7]
              for i in range(n_frames)), "train.json entries: 9 values, "
          "T_l <= frame <= T_u")
    rec.update({
        "decisions": [[i, a, m] for i, a, m in decisions],
        "forwards": len(decisions), "sampled_frames": sampled,
        "forwards_per_sampled_frame": len(decisions) / sampled,
        "picked_frames": picked, "bbox_picked_freq": stats[2],
        "corner_bbox_freq": stats[4], "correlation_launches": launches})

    triple = (0, 4, 8)
    pre = [helper.preprocess(f[..., ::-1]) for f in frames[:9]]
    rec["conv_gflop_per_forward"] = conv_gflop(
        helper.model, torch.cat([pre[0], pre[4], pre[8]])[None])
    if device.type == "cuda":
        ms = time_device_ms(lambda: helper.forward(pre, *triple))

        def loop_step():  # a forward as the loop makes it, with its sync
            flow = resize_flow(helper.forward(pre, *triple), h, w)
            return float(flow.abs().amax())

        full = resize_flow(helper.forward(pre, *triple), h, w)
        rec["forward"] = {
            "device_ms": ms, "tflop_per_s":
                rec["conv_gflop_per_forward"]["total"] / ms,
            "call_ms": time_call_ms(lambda: helper.forward(pre, *triple)),
            "loop_step_ms": time_call_ms(loop_step),
            "flow_to_host_ms": time_call_ms(
                lambda: full[0].permute(1, 2, 0).cpu().numpy())}
        rec["profile"] = _flow_profile(helper, pre, triple, device)
    rec["host_ms_per_frame"] = {
        "preprocess": 1e3 * sec["preprocess"] / counts["preprocess"],
        "flow_to_bbox": 1e3 * sec["flow_to_bbox"] / counts["flow_to_bbox"],
        "smooth_bbox_dp": 1e3 * sec["smooth_bbox_dp"] / n_frames,
        "crop": 1e3 * sec["crop"] / n_frames}
    rec["seconds_per_video"] = sec
    rec["seconds_per_video_cold"] = cold["total"]
    rec["frames_mined_per_s"] = n_frames / sec["total"]
    if "forward" in rec:  # computed from the graph's device time, not traced
        rec["card_idle_share"] = 1.0 - len(decisions) * rec["forward"][
            "device_ms"] / (1e3 * sec["total"])
    print(json.dumps({"pseudo_labels": rec}), flush=True)

    t0 = time.perf_counter()
    rec["gpu_vs_cpu"] = mining_vs_cpu(helper, cpu, frames, decisions,
                                      kept_boxes)
    rec["gpu_vs_cpu"]["seconds"] = time.perf_counter() - t0
    vs = rec["gpu_vs_cpu"]
    print(json.dumps({"pseudo_labels_gpu_vs_cpu": {
        k: vs[k] for k in ("preprocess_scaled_err", "decisions_held",
                           "min_margin_px", "max_flow_gap_px",
                           "max_scaled_err", "seconds")} | {
        "boxes": [{k: b[k] for k in ("distance_gap", "threshold_margin",
                                     "mask_flips", "held_equal", "equal",
                                     "box_max_dev_px", "reproduces_run")}
                  for b in vs["boxes"]]}}), flush=True)
    return rec, launches


# ------------------------------------ TraX, the evaluation, the one-key chain

def png_bytes(image):
    """A BGR uint8 (H, W, 3) frame as an RGB PNG file's bytes (zlib, no
    image library): what `eval.datasets._image_size` reads a size from."""
    import struct
    import zlib

    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image[..., ::-1]).reshape(
                               h, w * 3)], axis=1)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


class FrameStore:
    """Frames held in memory by path, for a machine with no image codec:
    `write(path, image)` keeps the array and, for a `.png` path, writes
    the PNG file too (its header and its listing are all the port reads
    from disk); `read(path)` gives the array back (None if absent, as
    `read_image` answers an unreadable file)."""

    def __init__(self):
        self.frames = {}

    def write(self, path, image):
        self.frames[os.path.normpath(path)] = image
        if path.endswith(".png"):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(png_bytes(image))

    def read(self, path):
        return self.frames.get(os.path.normpath(str(path)))


def _trax_toolkit(fmt, ckpt, paths, init_region, device, reader, width,
                  channels, mem_size):
    """One TraX session: `cli.vot_wrapper.run` in a thread over a pair of
    pipes, this function the toolkit, one message at a time. Returns
    (the `state` messages after the init's echo, ms from writing each
    `frame` to reading its `state`, the init's echo ms, ms to the
    hello)."""
    import threading

    from usot_tpu_torch.cli import vot_wrapper
    from usot_tpu_torch.eval import trax_protocol as tp

    to_tracker, from_tracker = os.pipe(), os.pipe()
    fin = os.fdopen(to_tracker[0], "r")
    fout = os.fdopen(from_tracker[1], "w")
    send_f = os.fdopen(to_tracker[1], "w")
    recv_f = os.fdopen(from_tracker[0], "r")
    failed = []
    threads = torch.get_num_threads()

    def serve():
        # a thread's own CPU op pool (OpenMP): the direct tracker's size,
        # so a CPU run sums in the same order
        torch.set_num_threads(threads)
        try:
            vot_wrapper.run(ckpt, fmt, mem_size=mem_size, width=width,
                            channels=channels, device=device, reader=reader,
                            fin=fin, fout=fout)
        except BaseException as e:  # noqa: BLE001 - reported below
            failed.append(e)
        finally:
            fout.close()  # the toolkit reads EOF if the tracker died

    def expect(mtype):
        while True:
            line = recv_f.readline()
            check(line, f"TraX {fmt}: the tracker closed its pipe awaiting "
                  f"{mtype}: {failed}")
            msg = tp.parse_message(line)
            if msg is not None:
                check(msg[0] == mtype, f"TraX {fmt}: {msg[0]} for {mtype}")
                return msg

    def send(mtype, args=()):
        send_f.write(tp.format_message(mtype, args) + "\n")
        send_f.flush()

    thread = threading.Thread(target=serve, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        _, _, hello = expect("hello")
        hello_ms = (time.perf_counter() - t0) * 1e3
        check(hello["trax.region"] == fmt and hello["trax.image"] == "path",
              f"TraX hello {hello}")
        t0 = time.perf_counter()
        send("initialize", (paths[0], tp.encode_region(init_region)))
        expect("state")
        init_ms = (time.perf_counter() - t0) * 1e3
        states, frame_ms = [], []
        for p in paths[1:]:
            t0 = time.perf_counter()
            send("frame", (p,))
            states.append(expect("state"))
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        send("quit")
        expect("quit")
    finally:
        send_f.close()
        thread.join(timeout=120)
        recv_f.close()
        fin.close()
    check(not thread.is_alive() and not failed,
          f"TraX {fmt}: the wrapper failed: {failed}")
    return states, frame_ms, init_ms, hello_ms


def run_trax(device, width=64, channels=256, mem_size=4, n_frames=60,
             rect_hw=(480, 640), mask_hw=(720, 1280), box=48, card=""):
    """Phase 14a: the VOT2020/TraX entry point at full width,
    `cli.vot_wrapper.run` on seeded random weights with calibrated BN
    (`cli.test.load_model`'s route, saved as a `.pth` the wrapper
    loads), played by this script as the toolkit over pipes, the frames
    held in memory (`reader`): a `rectangle` session on a 480x640 video
    and a `mask` (VOT2020) session on a 720x1280 video started from a
    mask. Every frame's `state` carries a confidence, every mask is
    nonempty; the reported regions against the same frames tracked
    directly by `USOTTracker` + `ModelRunner` on the same weights in
    this process (rectangles within 1e-3 px, masks equal, confidences
    within 1e-5); K1 exactly 3 times per tracked frame. Records ms per
    frame through the protocol beside the tracker alone, the mask's RLE
    encode and decode ms at 720p, the init's. Returns (record, K1
    launches of the two sessions)."""
    import argparse
    import tempfile

    from usot_tpu_torch.cli.test import load_model
    from usot_tpu_torch.cli.vot_wrapper import mask_from_rect, rect_from_mask
    from usot_tpu_torch.core.geometry import cxy_wh_2_rect
    from usot_tpu_torch.eval import trax_protocol as tp
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.tracker.tracker import USOTTracker

    rec = {"card": card, "width": width, "channels": channels,
           "frames": n_frames}
    t0 = time.perf_counter()
    model = load_model(argparse.Namespace(
        resume="", mem_size=mem_size, width=width, channels=channels,
        dtype="float32"), device)
    rec["model_s"] = time.perf_counter() - t0
    runner = ModelRunner(model, device=device)
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "usot_random.pth")
        torch.save(model.state_dict(), ckpt)
        for fmt, (h, w) in (("rectangle", rect_hw), ("mask", mask_hw)):
            frames, centers = synthetic_video(n_frames, box, h, w,
                                              seed=len(fmt))
            paths = [f"{fmt}/{i:04d}.png" for i in range(n_frames)]
            by_path = dict(zip(paths, frames))
            cx, cy = centers[0]
            x0, y0 = cx - box // 2, cy - box // 2
            if fmt == "mask":
                init = np.zeros((h, w), np.uint8)
                init[y0:y0 + box, x0:x0 + box] = 1
                region = tp.Mask.create(init)
                pos_sz = rect_from_mask(init)
            else:
                region = tp.Rectangle.create(x0, y0, box, box)
                pos_sz = [x0 + box / 2, y0 + box / 2, box, box]

            reset_launch_counts()  # the TraX session's path starts here
            states, frame_ms, init_ms, hello_ms = _trax_toolkit(
                fmt, ckpt, paths, region, device, by_path.get, width,
                channels, mem_size)
            k1 = launch_counts()["K1"]  # read just after the path
            total += k1
            tracked = n_frames - 1
            check(len(states) == tracked, f"TraX {fmt}: {len(states)} states")
            if device.type == "cuda":
                check(k1 == 3 * tracked, f"TraX {fmt}: {k1} K1 launches for "
                      f"{tracked} frames, expected {3 * tracked}")

            # the same frames tracked directly, the same weights
            tracker = USOTTracker()
            st = tracker.init(frames[0], np.array(pos_sz[:2], np.float64),
                              np.array(pos_sz[2:], np.float64), runner)
            direct, direct_ms = [], []
            for im in frames[1:]:
                t1 = time.perf_counter()
                st = tracker.track(st, im)
                direct_ms.append((time.perf_counter() - t1) * 1e3)
                direct.append((cxy_wh_2_rect(st["target_pos"],
                                             st["target_sz"]),
                               st["cls_score"]))
            px_err, conf_err, encode_ms, decode_ms = 0.0, 0.0, [], []
            for (_, args, props), (rect, conf) in zip(states, direct):
                check("confidence" in props, f"TraX {fmt}: no confidence")
                conf_err = max(conf_err, abs(float(props["confidence"])
                                             - conf))
                if fmt == "mask":
                    t1 = time.perf_counter()
                    full = tp.decode_region(args[0]).array(True, (w, h))
                    decode_ms.append((time.perf_counter() - t1) * 1e3)
                    t1 = time.perf_counter()
                    tp.Mask.create(full).encode()
                    encode_ms.append((time.perf_counter() - t1) * 1e3)
                    check(full.sum() > 0, "TraX mask: an empty mask")
                    check(np.array_equal(full, mask_from_rect(rect, (w, h))),
                          "TraX mask: the reported mask is not the direct "
                          "tracker's rectangle filled")
                else:
                    got = np.array(tp.decode_region(args[0]).bounds())
                    px_err = max(px_err, float(np.abs(got - rect).max()))
            check(px_err <= 1e-3 and conf_err <= 1e-5,
                  f"TraX {fmt}: {px_err} px, confidence {conf_err} from the "
                  "direct tracker")
            srec = {"frame_hw": [h, w], "k1_launches": k1,
                    "ms_per_frame_median": statistics.median(frame_ms),
                    "ms_per_frame_min": min(frame_ms),
                    "tracker_alone_ms_median": statistics.median(direct_ms),
                    "tracker_alone_ms_min": min(direct_ms),
                    "init_echo_ms": init_ms,
                    "first_frame_ms": frame_ms[0],
                    "startup_s": hello_ms / 1e3,
                    "max_abs_px_vs_direct": px_err,
                    "max_abs_confidence_vs_direct": conf_err}
            if fmt == "mask":
                srec["rle_encode_ms_median"] = statistics.median(encode_ms)
                srec["rle_decode_ms_median"] = statistics.median(decode_ms)
            rec[fmt] = srec
            print(json.dumps({f"trax_{fmt}": srec}), flush=True)
    return rec, total


def _vot_tags(n):
    return {t: [0] * n for t in ("camera_motion", "illum_change",
                                 "motion_change", "size_change",
                                 "occlusion")}


def score_protocols(protocols_root, proto_rec, vot, refill, card=""):
    """Phase 14b: `cli.evaluate` on the card's host scores phase 9's
    result files (the VOT restart protocol's, the lane refill's OTB
    layout), with the dataset JSONs and each video's first frame as a
    PNG (zlib, `png_bytes`) in a temporary dataset root (the JSONs also
    written beside the results). The VOT results are scored
    under VOT2019's EAO window (46-291 frames, which the 40-64-frame
    videos reach; VOT2018's starts at frame 100, past all of them, where
    the toolkit's EAO is NaN by definition); the restart protocol is the
    same. Held: every video scored, each video's failures equal to phase
    9's restart count (the `2` rows of its skeleton), AUC, EAO and
    accuracy finite. Records seconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _score_protocols(root, protocols_root, proto_rec, vot, refill,
                                card)


def _score_protocols(root, protocols_root, proto_rec, vot, refill, card):
    from usot_tpu_torch.cli.evaluate import evaluate

    rec = {"card": card}
    t0 = time.perf_counter()
    for name, videos, tags in (("VOT2019", vot, True),
                               ("OTB2015", refill, False)):
        meta = {}
        for v, video in videos.items():
            frames = video["image_files"]
            names = [f"{v}/{i:08d}.png" for i in range(len(frames))]
            path = os.path.join(root, name, names[0])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(png_bytes(frames[0]))
            gt = np.asarray(video["gt"], np.float64)
            if not tags:  # the OTB layout's ground truth is 1-indexed
                gt = gt + [1, 1, 0, 0]
            meta[v] = {"video_dir": v, "init_rect": gt[0].tolist(),
                       "img_names": names, "gt_rect": gt.tolist(),
                       **(_vot_tags(len(frames)) if tags else {"attr": []})}
        for where in (root, protocols_root):
            with open(os.path.join(where, name + ".json"), "w") as f:
                json.dump(meta, f)
    rec["write_s"] = time.perf_counter() - t0

    for v, video in vot.items():  # phase 9's videos, made again
        with open(os.path.join(protocols_root, "batch", "VOT2018", "USOT",
                               "baseline", v, v + "_001.txt")) as f:
            n_rows = len(f.read().split())
        check(n_rows == len(video["image_files"]),
              f"VOT {v}: {n_rows} result rows, "
              f"{len(video['image_files'])} frames")
    t0 = time.perf_counter()
    out = evaluate("VOT2019", root, os.path.join(
        protocols_root, "batch", "VOT2018"), ["USOT"])
    rec["vot_s"] = time.perf_counter() - t0
    fails = out["ar"]["USOT"]["failures"]
    check(sorted(fails) == sorted(vot), f"VOT scored {sorted(fails)}")
    restarts = {v: s.count("2")
                for v, s in proto_rec["vot"]["skeletons"].items()}
    check({v: f[0] for v, f in fails.items()} == restarts,
          f"VOT failures {fails} != phase 9's restarts {restarts}")
    overlaps = [x for o in out["ar"]["USOT"]["overlaps"].values() for x in o]
    accuracy = float(np.nanmean(overlaps))
    eao = float(out["eao"]["USOT"]["all"])
    check(np.isfinite(accuracy) and np.isfinite(eao),
          f"VOT accuracy {accuracy}, EAO {eao}")

    t0 = time.perf_counter()
    ope = evaluate("OTB2015", root, os.path.join(
        protocols_root, "refill", "OTB2015"), ["USOT"])
    rec["otb_s"] = time.perf_counter() - t0
    success = ope["success"]["USOT"]
    check(sorted(success) == sorted(refill), f"OTB scored {sorted(success)}")
    auc = float(np.mean([np.mean(s) for s in success.values()]))
    check(np.isfinite(auc), f"OTB AUC {auc}")
    rec.update({"vot_videos": len(fails), "failures": restarts,
                "accuracy": accuracy, "eao_vot2019_window": eao,
                "otb_videos": len(success), "auc": auc,
                "seconds": rec["vot_s"] + rec["otb_s"]})
    print(json.dumps({"evaluate": rec}), flush=True)
    return rec


def run_onekey(device, n_frames=24, raw_hw=(720, 1280), bench_hw=(480, 640),
               bench_videos=2, bench_frames=30, batch=12, mem=4, iters=2,
               width=None, channels=None, card=""):
    """Phase 14c: the one-key chain in this process, `cli.onekey.main`
    with the config as a dict and `onekey.in_process` as its
    `run_stage`, frames held in memory (`FrameStore`): one mined video
    (phase 13's 720x1280 video, `n_frames` frames; PWCLite with fixed
    random weights, `--keep_all`), two epochs of `iters` steps at B=12
    (naive, then cycle memory unfrozen, 4 memory frames), `test_epochs`
    over both checkpoints on a 2-video 480x640 OTB-layout benchmark of
    30 frames (the parity engine), and `evaluate`. Held: every stage's
    artifacts, a result directory per epoch with every video's rows, the
    evaluation ran and its AUC is finite; K1 3 times per tested frame.
    Records `STAGE_TIMES`. Returns (record, K1 launches on the chain)."""
    import tempfile

    from usot_tpu_torch.cli import onekey
    from usot_tpu_torch.tools import onekey_synthetic as synth

    rec = {"card": card}
    with tempfile.TemporaryDirectory() as work:
        store = FrameStore()
        t0 = time.perf_counter()
        for i, im in enumerate(mining_video(n_frames, *raw_hw)):
            store.write(os.path.join(work, "raw", "video00", f"{i:04d}.png"),
                        im)
        synth.build_benchmark(os.path.join(work, "bench"), bench_videos,
                              bench_frames, *bench_hw, writer=store.write,
                              ext=".png")
        rec["data_s"] = time.perf_counter() - t0
        cfg = synth.build_config(work, samples=iters * batch, mem_num=mem,
                                 width=width, channels=channels, batch=batch)
        cfg["USOT"]["WORKERS"] = min(8, os.cpu_count() or 1)
        reset_launch_counts()  # the one-key chain's path starts here
        t0 = time.perf_counter()
        onekey.main(["--device", str(device)], cfg=cfg,
                    run_stage=onekey.in_process(cfg, reader=store.read,
                                                writer=store.write))
        rec["seconds"] = time.perf_counter() - t0
        k1 = launch_counts()["K1"]  # read just after the path
        rec["stage_times"] = dict(onekey.STAGE_TIMES)
        check(list(rec["stage_times"]) == ["preprocess", "train",
                                           "test_epochs", "evaluate"],
              f"onekey stages {rec['stage_times']}")
        prep = os.path.join(work, "prep")
        with open(os.path.join(prep, "train.json")) as f:
            train_json = json.load(f)
        crops = [p for p in store.frames if ".x.jpg" in p]
        check(list(train_json) == ["video00"] and len(crops) == n_frames
              and os.path.exists(os.path.join(prep, "raw.json")),
              f"preprocess: {list(train_json)}, {len(crops)} crops")
        with open(os.path.join(work, "log", "train_record.json")) as f:
            record = json.load(f)
        check(sorted(record["epochs"]) == ["5", "6"] and all(
            e["n_iters"] == iters and np.all(np.isfinite(e["losses"]))
            for e in record["epochs"].values())
            and record["epochs"]["6"]["cycle_memory"],
            f"train: {record['epochs']}")
        check(sorted(os.listdir(os.path.join(work, "snapshot"))) == [
            "checkpoint_e5.pth", "checkpoint_e6.pth"], "checkpoints")
        result = os.path.join(work, "result", "OTB2015")
        trackers = sorted(os.listdir(result))
        check(trackers == ["USOTcheckpoint_e5", "USOTcheckpoint_e6"],
              f"result directories {trackers}")
        for t in trackers:
            for v in range(bench_videos):
                with open(os.path.join(result, t, f"Synth{v}.txt")) as f:
                    rows = f.read().split()
                check(len(rows) == bench_frames, f"{t}/Synth{v}: {len(rows)}")
        summary = synth.summarize(work)
        check(all(np.isfinite(a) for a in summary["auc"].values()),
              f"onekey AUC {summary['auc']}")
        tested = len(trackers) * bench_videos * (bench_frames - 1)
        if device.type == "cuda":
            check(k1 == 3 * tested, f"onekey: {k1} K1 launches for {tested} "
                  f"tested frames, expected {3 * tested}")
        rec.update({"auc": summary["auc"], "k1_launches": k1,
                    "losses": {e: r["losses"]
                               for e, r in record["epochs"].items()},
                    "tested_frames": tested})
    print(json.dumps({"onekey": rec}), flush=True)
    return rec, k1


def run_entry(device):
    """Phase 14d: `usot_tpu_torch.entry.entry()` once: the output shapes
    and K1's three launches. Returns (record, K1 launches)."""
    from usot_tpu_torch.entry import entry

    fn, args = entry(device)
    reset_launch_counts()  # entry's path starts here
    out = fn(*args)
    sync(device)
    k1 = launch_counts()["K1"]  # read just after the path
    shapes = [list(o.shape) for o in out]
    check(shapes == [[1, 25, 25, 1], [1, 25, 25, 4], [1, 25, 25, 1],
                     [1, 31, 31, 256]], f"entry shapes {shapes}")
    check(all(bool(torch.isfinite(o).any()) for o in out), "entry: no "
          "finite output")
    if device.type == "cuda":
        check(k1 == 3, f"entry: {k1} K1 launches, expected 3")
    rec = {"shapes": shapes, "k1_launches": k1}
    print(json.dumps({"entry": rec}), flush=True)
    return rec, k1


# ------------------------------------------------------- data parallelism

def _gap(a, b):
    """max |a - b| over max(max |b|, 1), as float64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def _step_gaps(out_s, out_p, conf_s, conf_p):
    """Per lane, scale-aware gaps of one step's pos, sz, score and memory
    confidences: {key: (B,) float64}."""
    got = dict(zip(("pos", "sz", "score"), out_s), mem_conf=conf_s)
    want = dict(zip(("pos", "sz", "score"), out_p), mem_conf=conf_p)
    gaps = {}
    for k in got:
        a = got[k].detach().double().cpu().reshape(got[k].shape[1], -1)
        b = want[k].detach().double().cpu().reshape(want[k].shape[1], -1)
        scale = max(float(b.abs().max()), 1.0)
        gaps[k] = ((a - b).abs().amax(dim=1) / scale).numpy()
    return gaps


def _picked_cells(sharded, plain, st_p, frames):
    """(B,) bool: the lanes whose step from the unsharded carry `st_p` on
    `frames` (B, H, W, 3) picks, in each shard, the score-map cell the
    unsharded engine picks."""
    from usot_tpu_torch.tracker.engine import best_cells

    def cells(eng, st, x):
        scale_z, xf = eng._search(st, x, eng._avg_b, eng._im_hw_b,
                                  eng._origin0)
        return best_cells(eng.p, eng._consts, st.sz, scale_z,
                          *eng._heads(st, xf)).to(plain.device)

    with torch.inference_mode():
        want = cells(plain, st_p, frames)
        got = torch.cat([cells(sh, sst, frames[a:b]) for sh, sst, (a, b) in
                         zip(sharded._shards,
                             sharded.scatter_state(st_p).shards,
                             sharded._lanes)])
    return (got == want).cpu().numpy()


# bf16: the keys held on the lanes whose argmax cell agrees
BF16_HELD = ("score", "mem_conf")


def _hold_gaps(gaps, agree, tol, bf16, label, min_agree=0.5,
               what="sharded engine", against="the unsharded engine"):
    """f32: every gap within `tol`. bf16: the scores and memory
    confidences within `tol` on the lane-steps whose score-map argmax
    agrees with the unsharded engine's (`agree`, a list of (B,) bool
    like each key's gaps; at least `min_agree` of them must agree), the
    positions and sizes recorded. There the two engines' bf16
    convolutions (B=16 against B=32) round apart, and on random weights
    the argmax flips between near-equal cells whose boxes lie pixels
    apart and whose scores differ. Returns the record."""
    rec = {}
    if bf16:
        agree = np.concatenate(agree)
        rec["argmax_agrees_share"] = share = float(np.mean(agree))
        check(share >= min_agree, f"{what} {label}: the argmax "
              f"agrees with {against}'s on {share} of the "
              f"lane-steps (at least {min_agree})")
    for k, g in gaps.items():
        g = np.concatenate(g)
        held = not bf16 or k in BF16_HELD
        ga = g[agree] if bf16 else g
        over = float(np.mean(~(ga <= tol))) if ga.size else 0.0
        rec[k] = {"max": float(np.max(g)),
                  "share_over_tol": float(np.mean(~(g <= tol))),
                  "held": held}
        if bf16:
            rec[k].update(max_agreeing=float(np.max(ga)) if ga.size else 0.0,
                          share_over_tol_agreeing=over)
        check(not held or over == 0.0,
              f"{what} {label} against {against}: {k} "
              f"{rec[k]}, tol {tol}")
    return rec


def _stages_vs_plain(sharded, plain, st_p, frames, tol, label):
    """One frame step stage by stage from the unsharded carry `st_p`,
    each shard against the unsharded engine's lanes, scale-aware at
    `tol`: the crop and backbone (search features), and the heads fed
    the unsharded engine's features (cls, cls_mem, and the boxes in
    their exponent on the cells finite on both sides: random weights
    overflow the bbox exp; in bf16 at most 1 % of the cells may
    overflow on one side only, as phase 11 allows)."""
    st_s = sharded.scatter_state(st_p)
    rec = {}
    with torch.inference_mode():
        _, xf_p = plain._search(st_p, frames, plain._avg_b, plain._im_hw_b,
                                plain._origin0)
        heads_p = plain._heads(st_p, xf_p)
        for sh, sst, (a, b) in zip(sharded._shards, st_s.shards,
                                   sharded._lanes):
            _, xf_s = sh._search(sst, frames[a:b], sh._avg_b, sh._im_hw_b,
                                 sh._origin0)
            heads_s = sh._heads(sst, xf_p[a:b])
            pairs = {"search_features": (xf_s, xf_p[a:b]),
                     "cls": (heads_s[0], heads_p[0][a:b]),
                     "bbox_exponent": (torch.log(heads_s[1]),
                                       torch.log(heads_p[1][a:b])),
                     "cls_mem": (heads_s[2], heads_p[2][a:b])}
            for k, (x, y) in pairs.items():
                both = torch.isfinite(x) & torch.isfinite(y)
                differ = int((torch.isfinite(x) != torch.isfinite(y)).sum())
                gap = _gap(x[both], y[both])
                check(bool(both.any()) and gap <= tol and differ <= (
                    0.01 * x.numel() if label.startswith("bf") else 0),
                      f"sharded engine {label}, lanes {a}-{b - 1}, {k}: "
                      f"{gap} (tol {tol}), {differ} cells overflow on one "
                      "side")
                prev = rec.get(k, {"max": 0.0, "overflow_differs": 0})
                rec[k] = {"max": max(prev["max"], gap), "overflow_differs":
                          prev["overflow_differs"] + differ}
    return rec


def _sharded_vs_plain(sharded, plain, st_p, block, valid, forced, tol,
                      label):
    """`forced` frame steps, each from the unsharded engine's carry: the
    sharded engine's positions, sizes, scores and memory confidences
    against the unsharded engine's, scale-aware per lane. Returns (the
    record, the unsharded carry after the steps)."""
    gaps = {k: [] for k in ("pos", "sz", "score", "mem_conf")}
    bf16, agree = label.startswith("bf"), []
    for t in range(forced):
        b, v = block[t:t + 1], valid[t:t + 1]
        if bf16:
            agree.append(_picked_cells(sharded, plain, st_p, block[t]))
        st_s, out_s = sharded.run_chunk(sharded.scatter_state(st_p), b, v,
                                        donate=False)
        st_p, out_p = plain.run_chunk(st_p, b, v)
        conf_s = torch.cat([sh.mem_conf for sh in st_s.shards])
        for k, g in _step_gaps(out_s, out_p, conf_s[None],
                               st_p.mem_conf[None]).items():
            gaps[k].append(g)
    return _hold_gaps(gaps, agree, tol, bf16, label), st_p


def _splice_boundary(sharded, plain, st_p, runner, frames, block, valid,
                     tol, label):
    """The two lanes either side of the shard boundary (15 and 16 at
    B=32) spliced with fresh videos into the unsharded carry `st_p` and
    into a sharded copy of it: the gathered sharded carry equals the
    unsharded one bitwise, and one step after, every lane's outputs are
    held as the teacher-forced steps are."""
    st_s = sharded.scatter_state(_clone(st_p))
    half = sharded.batch // 2
    lanes = [half - 1, half]
    inits = [(frames[5], np.array([230.0, 250.0]), np.array([50.0, 70.0])),
             (frames[9], np.array([180.0, 230.0]), np.array([64.0, 48.0]))]
    fresh = sharded.make_lane_states(inits, runner)
    st_s = sharded.splice_lanes(st_s, lanes, fresh)
    st_p = plain.splice_lanes(st_p, lanes, fresh)
    equal = all(torch.equal(a, b) for a, b in zip(
        _leaves(sharded.gather_state(st_s)) + [sharded._avg_b,
                                                sharded._im_hw_b],
        _leaves(st_p) + [plain._avg_b, plain._im_hw_b]))
    check(equal, f"sharded splice {label}: lanes {lanes} differ from the "
          "unsharded splice")
    agree = _picked_cells(sharded, plain, st_p, block[0])
    st_s, out_s = sharded.run_chunk(st_s, block[:1], valid[:1])
    st_p, out_p = plain.run_chunk(st_p, block[:1], valid[:1])
    conf_s = torch.cat([sh.mem_conf for sh in st_s.shards])
    gaps = _step_gaps(out_s, out_p, conf_s[None], st_p.mem_conf[None])
    rec = _hold_gaps({k: [g] for k, g in gaps.items()}, [agree], tol,
                     label.startswith("bf"), f"{label} after the splice")
    moved = float((out_p[0][:, half] - out_p[0][:, 0]).abs().max())
    check(moved > 1.0, f"splice {label}: lane {half} still tracks lane 0")
    return {"lanes": lanes, "carry_equal": equal, "step": rec}


def run_sharded_engine(model, device, f32_rec, bf16_rec, batch=32,
                       n_frames=129, chunk=64, forced=64, repeats=2, h=480,
                       w=640, card=""):
    """Phase 15a: the sharded batch engine on one card (two shards on
    `device`), f32 then bf16, against the unsharded engine. Returns
    (record, K1 launches on the sharded path).

    Held (`_hold_gaps`): the lanes' outputs on `forced` teacher-forced
    steps and one step after a splice across the shard boundary. The
    timed runs track
    free-running on random weights, which walk the tracker off and, in
    a B=16 batch, to non-finite boxes (an unsharded engine of B=16 does
    the same at the same step on the same frames): their values are
    counted, not held. The bbox exp of random weights sits at f32's
    overflow edge, which the last bits of the convolutions decide (on the
    CPU both packages overflow at the first step,
    `tests/test_torch_port_random_b16.py`); on trained weights every lane
    of B=16 and B=32 stays finite (phase 16c)."""
    from usot_tpu_torch.parallel.mesh import make_mesh
    from usot_tpu_torch.tracker.engine import BatchScanEngine, \
        synthetic_video as bench_video
    from usot_tpu_torch.tracker.runner import ModelRunner

    mesh = make_mesh(devices=[device, device])
    p = _tracker_config("small")
    frames = bench_video(n_frames, h=h, w=w)
    videos = [(frames[0], np.array([200.0, 240.0]), np.array([60.0, 60.0]))
              for _ in range(batch)]
    single = np.stack(frames[1:])
    all_frames = np.broadcast_to(single[None], (batch,) + single.shape)
    n_steps = n_frames - 1
    rec, k1_path = {"mesh": [str(d) for d in mesh.devices],
                    "shards": mesh.size, "batch": batch, "chunk": chunk,
                    "frames": n_frames, "card": card}, 0
    for label, m, tol, ref in (
            ("float32", model, 1e-3, f32_rec),
            ("bfloat16", bf16_model(model), BF16_LANE_TOL, bf16_rec)):
        runner = ModelRunner(m, device=device)
        kw = dict(max_frames=max(256, n_frames + 8), chunk=chunk)
        plain = BatchScanEngine(m, p, h, w, batch, device=device, **kw)
        sharded = BatchScanEngine(m, p, h, w, batch, mesh=mesh, **kw)
        staged = sharded.stage_frames(all_frames, np.full(batch, n_steps))
        _, block, valid = staged[0]
        st = sharded.init_batch(videos, runner)
        st_p = plain.init_batch(videos, runner)
        stages = _stages_vs_plain(sharded, plain, st_p, block[0], tol, label)
        forced_rec, st_p = _sharded_vs_plain(sharded, plain, st_p, block,
                                             valid, forced, tol, label)
        sync(device)
        reset_launch_counts()  # the sharded path starts here
        t0 = time.perf_counter()
        with no_host_sync(device):
            st, outs = sharded.run_chunk(st, block, valid)
        pos = [sharded._collate([(chunk, outs)])[0]]
        warm_s = time.perf_counter() - t0
        rest = staged[1:]
        n_rest = sum(nb for nb, _, _ in rest)
        step_ms = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            st, p_rest, _, _ = sharded.track_staged(st, rest)
            step_ms.append((time.perf_counter() - t0) / n_rest * 1e3)
            pos.append(p_rest)
        steps = chunk + repeats * n_rest
        k1 = launch_counts()["K1"]  # read just after the path
        by_batch = launch_batches()["K1"]
        if device.type == "cuda":
            check(k1 == 3 * mesh.size * steps
                  and by_batch == {batch // mesh.size: k1},
                  f"sharded engine {label}: K1 launches {by_batch} for "
                  f"{steps} steps, expected {3 * mesh.size * steps} on "
                  f"{batch // mesh.size} lanes")
        k1_path += k1
        pos = np.concatenate(pos, axis=1)
        check(pos.shape == (batch, steps, 2)
              and int(sharded.gather_state(st).mem_len.min()) == 1 + steps,
              f"sharded engine {label}: {pos.shape}, mem_len")
        splice = _splice_boundary(sharded, plain, st_p, runner, frames,
                                  block, valid, tol, label)
        ms = statistics.median(step_ms)
        bad = ~np.isfinite(pos).all(axis=2)
        rec[label] = {
            "tol": tol, "stages_first_step": stages,
            "teacher_forced_steps": forced,
            "teacher_forced_gap": forced_rec,
            "splice_across_boundary": splice, "warm_chunk_s": warm_s,
            "ms_per_step": step_ms, "ms_per_step_median": ms,
            "fps_median": batch * 1e3 / ms, "frame_steps": steps,
            "free_running_nonfinite_lanes": int(bad.any(axis=1).sum()),
            "free_running_first_nonfinite_step":
                int(np.argmax(bad.any(axis=0))) if bad.any() else None,
            "k1_launches": k1, "k1_launches_per_step": k1 / steps,
            "k1_launches_by_lanes": by_batch,
            "unsharded": {k: ref[k] for k in (
                "ms_per_step_median", "fps_median",
                "k1_launches_per_step")}}
        print(json.dumps({f"sharded_engine_{label}": rec[label]}),
              flush=True)
        del plain, sharded, st, st_p, staged, block, valid
    rec["fixture"] = sharded_fixture(device)
    return rec, k1_path


def sharded_fixture(device, n_frames=21, box=48, size=320, batch=4,
                    tol_px=2e-3):
    """The trained w8c32 fixture on `run_fixture`'s video: B=4 lanes
    (ragged) sharded over two shards of `device` against the unsharded
    engine, free-running, in f32 and in bf16, within `tol_px` (JAX's
    mesh tolerance; the card measured 0 px in both). Returns the
    record."""
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.parallel.mesh import make_mesh
    from usot_tpu_torch.tracker.engine import BatchScanEngine
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.train.checkpoint import load_model_state
    from usot_tpu_torch.utils.msgpack import read_msgpack

    meta = read_msgpack(FIXTURE)
    kw = {k: int(meta[k]) for k in ("mem_size", "width", "channels")}
    weights = load_model_state(FIXTURE)
    frames, centers = synthetic_video(n_frames, box, h=size, w=size)
    videos = [(frames[0], np.array(centers[0], float),
               np.array([box, box], float))] * batch
    stack = np.stack([np.stack(frames[1:])] * batch)
    n_valid = np.array([20, 20, 13, 7])[:batch]
    p = _tracker_config("small")
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_usot(fused_xcorr=True, dtype=dtype, **kw)
        runner = ModelRunner(model, weights, device=device)
        out = {}
        for mesh in (None, make_mesh(devices=[device, device])):
            eng = BatchScanEngine(model, p, size, size, batch, max_frames=8,
                                  chunk=8, device=device, mesh=mesh)
            _, pos, sz, _ = eng.track_batch(eng.init_batch(videos, runner),
                                            stack, n_valid)
            out[mesh is not None] = (pos, sz)
        gap = max(float(np.abs(out[True][i][lane, :n]
                               - out[False][i][lane, :n]).max())
                  for i in (0, 1) for lane, n in enumerate(n_valid))
        name = str(dtype)[6:]
        rec[f"sharded_vs_unsharded_px_{name}"] = gap
        check(gap <= tol_px, f"fixture sharded vs unsharded {name}: {gap} "
              f"px > {tol_px}")
    print(json.dumps({"sharded_fixture": rec}), flush=True)
    return rec


def _dp_job(width, channels, batch, mem, world, seed=8):
    """Phase 15b's cases: seeded random weights (`init_model`, seed 0)
    and global batches of `batch x world` samples."""
    from usot_tpu_torch.data.shards import _pack_sample
    from usot_tpu_torch.models.usot import build_usot, init_model

    kw = dict(mem_size=mem, width=width, channels=channels)
    model = init_model(build_usot(**kw), torch.Generator().manual_seed(0),
                       device="cpu")
    state = {k: t.numpy() for k, t in model.state_dict().items()}
    rng = np.random.default_rng(seed)

    def global_batch(cycle):
        packed = [_pack_sample(training_sample(rng, cycle, mem))
                  for _ in range(batch * world)]
        return {k: np.stack([q[k] for q in packed]) for k in packed[0]}

    naive, cycle = global_batch(False), global_batch(True)
    base = dict(kind="step", accum=1, sync_bn=True, dtype="float32",
                timed=1)
    cases = [dict(base, name="naive_frozen", cycle=False, unfix=False,
                  batch=naive),
             dict(base, name="cycle_frozen", cycle=True, unfix=False,
                  batch=cycle),
             dict(base, name="cycle_unfrozen", cycle=True, unfix=True,
                  batch=cycle),
             dict(base, name="cycle_frozen_accum2", cycle=True,
                  unfix=False, accum=2, batch=cycle),
             dict(base, name="cycle_frozen_bn_sync_off", cycle=True,
                  unfix=False, sync_bn=False, batch=cycle, timed=0)]
    return dict(model=kw, state=state, cases=cases, full=False)


def _stat_gap(a, b):
    return max(_gap(torch.from_numpy(a[k]), torch.from_numpy(b[k]))
               for k in b)


def run_data_parallel_training(device, width=64, channels=256, batch=12,
                               mem=4, phase10=None, out_dir=None,
                               loss_tol=1e-4, grad_tol=1e-3, stat_tol=1e-4):
    """Phase 15b: two training ranks on `device` over gloo against one
    process on it with the global batch. Returns (record, the kernel
    launches the two ranks made, summed: training launches none)."""
    import tempfile

    from usot_tpu_torch.parallel.steps import one_process, run_ranks

    job = _dp_job(width, channels, batch, mem, 2)
    reset_launch_counts()
    t0 = time.perf_counter()
    ref_job = dict(job, cases=[dict(c, timed=0) for c in job["cases"]
                               if c["sync_bn"]])  # one process: rank 0
    ref = one_process(ref_job, device)
    ref_s = time.perf_counter() - t0
    ref_launches = launch_counts()
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the ranks need ~2 x 19 GB
    t0, wall0 = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        ranks = run_ranks(job, [device, device], "gloo", tmp)
    ranks_s = time.perf_counter() - t0
    for r in ranks:  # wall clocks of one host: from the launch
        r["_seconds"]["start"] -= wall0
        r["_seconds"]["end"] -= wall0
    # each rank counts its own launches (it resets its counts first)
    launches = {k: sum(r["_launches"][k] for r in ranks)
                for k in ranks[0]["_launches"]}
    rec = {"ranks": 2, "backend": "gloo", "devices": [str(device)] * 2,
           "batch_per_rank": batch, "global_batch": 2 * batch,
           "memory_frames": mem, "one_process_s": ref_s,
           "ranks_s": ranks_s,
           "rank_seconds": [r["_seconds"] for r in ranks],
           "launches_ranks": launches, "launches_one_process": ref_launches,
           "cases": {}}
    for case in job["cases"]:
        name = case["name"]
        if not case["sync_bn"]:
            continue
        a, b = (r[name] for r in ranks)
        check(a["digest"] == b["digest"], f"data parallel {name}: the "
              "ranks' parameters, BN stats or gradients differ")
        want = ref[name]
        loss = max(abs(a["metrics"][k] - want["metrics"][k])
                   / max(abs(want["metrics"][k]), 1e-12)
                   for k in want["metrics"])
        grads = max(_gap(torch.from_numpy(a["grads"][n]),
                         torch.from_numpy(want["grads"][n]))
                    for n in want["grads"])
        stats = max(_stat_gap(r[name]["stats"], want["stats"])
                    for r in ranks)
        r = {"loss_rel_err": loss, "grad_scaled_err": grads,
             "bn_stat_scaled_err": stats,
             "ms_per_step_rank": [x[name]["ms_per_step"] for x in ranks],
             "peak_bytes_rank": [x[name]["peak_bytes"] for x in ranks],
             "loss": a["metrics"]["loss"]}
        if phase10 and name in phase10:
            r["phase10_one_rank_b12"] = {k: phase10[name][k] for k in (
                "ms_per_step", "peak_bytes")}
        held = name != "cycle_unfrozen"
        check(stats <= stat_tol and (not held or (
            loss <= loss_tol and grads <= grad_tol)),
              f"data parallel {name} against one process: {r}")
        rec["cases"][name] = r
    off = ranks[0]["cycle_frozen_bn_sync_off"]
    gap = _stat_gap(off["stats"], ref["cycle_frozen"]["stats"])
    check(gap > 10 * stat_tol, f"per-rank BN statistics came within "
          f"{gap} of the global ones (bound {stat_tol})")
    rec["bn_sync_off_stat_scaled_err"] = gap
    print(json.dumps({"data_parallel_training": rec}), flush=True)
    return rec, launches


def run_nccl_and_dryrun(device, width=64, channels=256, batch=12, mem=4,
                        out_dir=None):
    """Phase 15c: `cli.train.train` with `--devices 1` in a NCCL group of
    one for 2 steps, and `entry.dryrun_multichip(2)`. Returns the
    record."""
    import tempfile

    from usot_tpu_torch.cli.train import train
    from usot_tpu_torch.entry import dryrun_multichip

    rec = {}
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        shards = os.path.join(tmp, "shards")
        write_training_shards(shards, 1, 3, 2 * batch, mem)
        cfg = training_config(os.path.join(tmp, "run"), width, channels,
                              batch, mem)
        t0 = time.perf_counter()
        out = train(cfg, train_args(shards, devices=1, stop_after_epoch=1),
                    device, backend=backend)
        rec["train_s"] = time.perf_counter() - t0
    losses = out["epochs"]["1"]["losses"]
    check(out["world"] == 1 and len(losses) == 2
          and all(np.isfinite(losses)),
          f"{backend} at world size 1: {out['epochs']}")
    rec.update(backend=backend, world=1, losses=losses)
    t0 = time.perf_counter()
    rec["dryrun_loss"] = dryrun_multichip(
        2, None if device.type == "cuda" else device)
    rec["dryrun_s"] = time.perf_counter() - t0
    print(json.dumps({"nccl_and_dryrun": rec}), flush=True)
    return rec


# ------------------------------------------------------- trained weights

# JAX's figures on its own chip, printed beside the port's and never
# held: `TRAIN_r05.json` (the full schedule) and `PARITY.md:128-133`
# (the accuracy run: the bf16 scan engine against the parity tracker)
JAX_TRAINED = {"loss_first_last": [5.107192, 1.312194],
               "auc_parity": 0.5748, "auc_batch_bf16": 0.5665,
               "precision20": [1.0, 1.0]}
ACC_F32_TOL = 0.005  # parity vs batch f32: |dAUC| of the OPE


def trained_schedule(device, out, width=64, channels=256, batch=8,
                     samples=16, end_epoch=30, kill=16, videos=12):
    """Phase 16a: `tools.train_full_schedule` through its subprocess path
    (unbroken, SIGKILLed in epoch `kill`, resumed) under `out`, at the
    tool's defaults but for `samples` per epoch: 16, two steps of B=8,
    where the tool's 32 (the checkpoint `regen_bench_ckpt` leaves) took
    312 s of the script's time limit on a slow host (sha256 of the
    file recorded; at 8 samples the weights' batch vs parity AUC gap
    broke the 0.005 limit). Held:
    every transition, the prefix and resume deltas at 0.0 (deterministic
    mode), the loss falling, no correlation kernel launched by the
    children. Returns the tool's record."""
    from usot_tpu_torch.tools import train_full_schedule as tfs

    argv = ["--end-epoch", str(end_epoch), "--kill", str(kill),
            "--width", str(width), "--channels", str(channels),
            "--samples", str(samples), "--batch", str(batch),
            "--videos", str(videos), "--root", os.path.abspath(out)]
    if device.type != "cuda":
        argv += ["--device", str(device)]
    rec = tfs.run(tfs.parse_args(argv))
    with open(rec["checkpoint_e_end"], "rb") as f:
        rec["checkpoint_sha256"] = hashlib.sha256(f.read()).hexdigest()
    check(rec["failures"] == [], f"full schedule: {rec['failures']}")
    check(all(v for v in rec["transitions"].values()),
          f"transitions {rec['transitions']}")
    check(rec["interrupted_prefix_max_delta"] == 0.0
          and rec["resume_max_loss_delta"] == 0.0,
          f"kill / resume deltas {rec['interrupted_prefix_max_delta']}, "
          f"{rec['resume_max_loss_delta']}")
    check(rec["loss_falls"], f"loss {rec['loss_first_last']}")
    launched = {leg: sum(c.values())
                for leg, c in rec["kernel_launches"].items()}
    check(not any(launched.values()),
          f"training launched a correlation kernel: {launched}")
    summary = {k: rec[k] for k in (
        "device", "torch", "model", "end_epoch", "kill_epoch",
        "transitions", "interrupted_prefix_max_delta",
        "resume_max_loss_delta", "loss_first_last", "wall_s", "shards",
        "unbroken_steps", "kernel_launches", "checkpoint_sha256")}
    summary["jax_loss_first_last"] = JAX_TRAINED["loss_first_last"]
    print(json.dumps({"trained_schedule": summary}), flush=True)
    return rec


def trained_accuracy(device, ckpt, out, width=64, channels=256, videos=6,
                     frames=40, f32_tol=ACC_F32_TOL, min_gain=0.0):
    """Phase 16b: `tools.accuracy_parity_run` on `ckpt`: the parity
    tracker (f32), the batch engine (f32, bf16) and the parity tracker on
    calibrated random weights through the test CLI and OPE. Held: every
    video scored, the f32 batch engine's AUC within `f32_tol` of the
    parity tracker's, the trained AUC more than `min_gain` above the
    random one. bf16's OPE gap is recorded (`trained_bf16_steps` holds
    bf16's decisions). Returns (record, K1 launches)."""
    from usot_tpu_torch.tools import accuracy_parity_run as acc

    argv = ["--ckpt", ckpt, "--root", os.path.abspath(out),
            "--videos", str(videos), "--frames", str(frames),
            "--width", str(width), "--channels", str(channels)]
    if device.type != "cuda":
        argv += ["--device", str(device)]
    reset_launch_counts()  # the accuracy runs start here
    t0 = time.perf_counter()
    res = acc.run(acc.parse_args(argv))
    k1 = launch_counts()["K1"]  # read just after the path
    f32 = res["delta_USOT_batch_f32"]
    check(f32["auc"] <= f32_tol,
          f"parity vs batch f32: |dAUC| {f32['auc']} > {f32_tol}")
    check(res["USOT_parity"]["auc"] - res["USOT_random"]["auc"] > min_gain,
          f"trained AUC {res['USOT_parity']['auc']} <= random "
          f"{res['USOT_random']['auc']}")
    rec = {**res, "seconds": time.perf_counter() - t0, "k1_launches": k1,
           "limits": {"f32_auc": f32_tol, "min_gain": min_gain},
           "jax": JAX_TRAINED}
    print(json.dumps({"trained_accuracy": rec}), flush=True)
    return rec, k1


def _cast_like(state, like):
    """A copy of an engine carry in the dtypes of the carry `like`."""
    if isinstance(state, torch.Tensor):
        return state.to(like.dtype, copy=True)
    items = [_cast_like(s, t) for s, t in zip(state, like)]
    return type(state)(*items) if hasattr(state, "_fields") else tuple(items)


def trained_bf16_steps(model, device, root, videos=6, frames=40,
                       tol=BF16_LANE_TOL, min_agree=0.5):
    """Phase 16b, bf16's decisions: the accuracy benchmark's videos (one
    lane each, initialised as the test CLI does) through the batch engine
    in f32 and in bf16, each bf16 step from the f32 engine's carry cast
    to bf16 (teacher-forced). Held as phase 15 holds bf16 (`_hold_gaps`):
    the score-map argmax agreeing with f32's on at least `min_agree` of
    the lane-steps, the scores and memory confidences within `tol` where
    it does. Returns (record, K1 launches)."""
    from usot_tpu_torch.core.geometry import get_axis_aligned_bbox
    from usot_tpu_torch.tools.accuracy_parity_run import build_benchmark
    from usot_tpu_torch.tracker.engine import BatchScanEngine, best_cells
    from usot_tpu_torch.tracker.runner import ModelRunner

    reader = build_benchmark(root, videos, frames)
    with open(os.path.join(root, "OTB2015.json")) as f:
        meta = json.load(f)
    clips, inits = [], []
    for v in meta.values():
        clip = np.stack([reader(os.path.join(root, "OTB2015", n))
                         for n in v["img_names"]])
        cx, cy, w, h = get_axis_aligned_bbox(
            np.asarray(v["gt_rect"][0], np.float64) - [1, 1, 0, 0])
        clips.append(clip)
        inits.append((clip[0], np.array([cx, cy]), np.array([w, h])))
    clips = np.stack(clips)  # (B, frames, H, W, 3)
    b, _, h, w, _ = clips.shape
    p = _tracker_config("small")
    m16 = bf16_model(model)
    e32, e16 = (BatchScanEngine(m, p, canvas_h=h, canvas_w=w, batch=b,
                                max_frames=frames + 8, chunk=1,
                                device=device) for m in (model, m16))
    st32 = e32.init_batch(inits, ModelRunner(model, device=device))
    like = e16.init_batch(inits, ModelRunner(m16, device=device))

    def cells(eng, st, x):
        scale_z, xf = eng._search(st, x, eng._avg_b, eng._im_hw_b,
                                  eng._origin0)
        return best_cells(eng.p, eng._consts, st.sz, scale_z,
                          *eng._heads(st, xf))

    gaps = {k: [] for k in ("pos", "sz", "score", "mem_conf")}
    agree = []
    valid = torch.ones(1, b, dtype=torch.bool, device=device)
    reset_launch_counts()  # the teacher-forced steps start here
    for t in range(1, frames):
        block = torch.from_numpy(clips[:, t][None]).to(device)
        st16 = _cast_like(st32, like)
        with torch.inference_mode():
            agree.append((cells(e16, st16, block[0])
                          == cells(e32, st32, block[0])).cpu().numpy())
        st16, out16 = e16.run_chunk(st16, block, valid)
        st32, out32 = e32.run_chunk(st32, block, valid)
        for k, g in _step_gaps(out16, out32, st16.mem_conf[None],
                               st32.mem_conf[None]).items():
            gaps[k].append(g)
    k1 = launch_counts()["K1"]  # read just after the path
    rec = _hold_gaps(gaps, agree, tol, True, "bf16", min_agree,
                     what="trained batch engine", against="float32")
    rec.update(lanes=b, steps=frames - 1, tol=tol, k1_launches=k1)
    print(json.dumps({"trained_bf16_steps": rec}), flush=True)
    return rec, k1


def trained_engine(model, device, batches=(16, 32), n_frames=65, chunk=64,
                   h=480, w=640):
    """Phase 16c: the batch engine free-running at each of `batches` on
    phase 7's video (its first 65 frames: random weights overflowed at
    step 24), in f32 and bf16, on the trained weights. Held: the
    boxes finite on every lane and step (`_check_track`). Returns
    (record, K1 launches)."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine, \
        synthetic_video as bench_video
    from usot_tpu_torch.tracker.runner import ModelRunner

    p = _tracker_config("small")
    frames = bench_video(n_frames, h=h, w=w)
    single = np.stack(frames[1:])
    rec, k1 = {}, 0
    for dtype, m in (("f32", model), ("bf16", bf16_model(model))):
        runner = ModelRunner(m, device=device)
        for b in batches:
            engine = BatchScanEngine(m, p, canvas_h=h, canvas_w=w, batch=b,
                                     max_frames=max(256, n_frames + 8),
                                     chunk=chunk, device=device)
            videos = [(frames[0], np.array([200.0, 240.0]),
                       np.array([60.0, 60.0]))] * b
            state = engine.init_batch(videos, runner)
            reset_launch_counts()  # this run's path starts here
            t0 = time.perf_counter()
            _, pos, sz, _ = engine.track_batch(
                state, np.broadcast_to(single[None], (b,) + single.shape),
                np.full(b, n_frames - 1))
            dt = time.perf_counter() - t0
            k1 += launch_counts()["K1"]  # read just after the path
            finite = bool(np.all(np.isfinite(pos)) and np.all(np.isfinite(sz)))
            rec[f"B={b} {dtype}"] = {
                "finite_every_lane_and_step": finite,
                "ms_per_step": dt / (n_frames - 1) * 1e3,
                "final_pos_lane0": pos[0, -1].tolist(),
                "final_sz_lane0": sz[0, -1].tolist()}
            _check_track(f"trained batch engine B={b} {dtype}", pos, sz)
            del engine
    print(json.dumps({"trained_engine": rec}), flush=True)
    return rec, k1


def run_trained_weights(device, width=64, channels=256, schedule_kw=None,
                        accuracy_kw=None, bf16_kw=None, engine_kw=None,
                        roi_kw=None, out_dir=None, card="", keep=None):
    """Phase 16: the full schedule's weights, trained here (16a), scored
    end to end and bf16's decisions on them held (16b), then tracking
    with them: the batch engine at B=16 and 32 (16c) and phase 9's ROI
    leg (16d, held at 1e-2 px, the engine's `roi_*` telemetry recorded).
    Returns (record, K1 launches on the path: 16b-d; the training
    children launch none). `keep`, a dict, receives the trained weights
    (a state dict on the CPU) under "weights"."""
    import tempfile

    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.train.checkpoint import load_model_state

    t_start = time.perf_counter()
    rec = {"card": card}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        sched = trained_schedule(device, os.path.join(tmp, "schedule"),
                                 width=width, channels=channels,
                                 **(schedule_kw or {}))
        rec["schedule"] = {k: sched[k] for k in (
            "transitions", "interrupted_prefix_max_delta",
            "resume_max_loss_delta", "loss_first_last", "wall_s", "shards",
            "unbroken_steps", "kernel_launches", "device", "torch",
            "checkpoint_sha256")}
        rec["schedule"]["loss_avg"] = {
            e: r["loss_avg"] for e, r in sched["epochs"].items()}
        ckpt = sched["checkpoint_e_end"]
        rec["accuracy"], k1_acc = trained_accuracy(
            device, ckpt, os.path.join(tmp, "accuracy"), width=width,
            channels=channels, **(accuracy_kw or {}))
        model = build_usot(mem_size=7, width=width, channels=channels,
                           fused_xcorr=True)
        model.load_state_dict(load_model_state(ckpt))
        if keep is not None:
            keep["weights"] = {k: t.clone()
                               for k, t in model.state_dict().items()}
        model = model.to(device).eval()
        rec["bf16_steps"], k1_bf16 = trained_bf16_steps(
            model, device, os.path.join(tmp, "bf16_steps"),
            **(bf16_kw or {}))
    rec["engine"], k1_engine = trained_engine(model, device,
                                              **(engine_kw or {}))
    rec["roi"], k1_roi = roi_leg(model, ModelRunner(model, device=device),
                                 _tracker_config("small"), device,
                                 **(roi_kw or {}))
    print(json.dumps({"trained_roi": rec["roi"]}), flush=True)
    k1 = {"accuracy": k1_acc, "bf16_steps": k1_bf16, "engine": k1_engine,
          "roi": k1_roi}
    if device.type == "cuda":
        check(all(n > 0 for n in k1.values()),
              f"trained weights: K1 not launched on every path {k1}")
    rec["k1_launches"] = dict(k1, total=sum(k1.values()))
    rec["seconds"] = time.perf_counter() - t_start
    return rec, sum(k1.values())


# ---------------------------------------------------- the measuring tools

BENCH_LEGS = {"init_batch", "warm_chunk", "fullframe_stream", "roi",
              "staged"}
# batch vs scan engine boxes, f32 (`tests/test_lockstep.py:78`), held for
# this many steps after every init; later steps are recorded only: on
# weights that lose their targets the ~1e-4 px per-step gaps of the two
# engines' reduction orders grow chaotically (the repo tool's note in
# `compare_results`; JAX's own 60-video run: p90 0.0014 px, max 79 px)
LOCKSTEP_TOL, LOCKSTEP_STEPS = 2e-3, 3


def run_bench_tool(weights, device, card="", sha256=None, **knobs):
    """Phase 17a: `tools.bench.run` at `bench.py`'s defaults (`knobs`
    override them) in bf16 and f32 on `weights`. Returns ({dtype:
    record}, K1 launches of both runs)."""
    from usot_tpu_torch.tools import bench

    base = bench.knobs({})
    base.pop("ckpt")
    base.update(knobs)
    rec, k1 = {}, 0
    for dtype in ("bf16", "f32"):
        reset_launch_counts()  # this run's path starts here
        r = bench.run(weights, device, **dict(base, dtype=dtype))
        k1 += launch_counts()["K1"]  # read just after the path
        r.pop("tracks")
        legs, staged = r["legs"], r["legs"]["staged"]
        check(set(legs) == BENCH_LEGS, f"bench {dtype}: legs {set(legs)}")
        check(legs["roi"].get("skipped") or "fps" in legs["roi"],
              f"bench {dtype}: the ROI leg neither ran nor logged a skip")
        check(sum(c["built"] for c in r["compile"]) == 0,
              f"bench {dtype}: nvcc builds {r['compile']}")
        if device.type == "cuda":
            check(staged["k1_launches"] == 3 * staged["frame_steps"],
                  f"bench {dtype}: K1 {staged['k1_launches']} launches in "
                  f"{staged['frame_steps']} staged steps")
        r.update(card=card, weights="phase 16 checkpoint_e30.pth",
                 weights_sha256=sha256)
        print(json.dumps(r["line"]), flush=True)
        print(json.dumps({f"bench_{dtype}": {k: r[k] for k in (
            "legs", "compile", "card")}}), flush=True)
        rec[dtype] = r
    return rec, k1


def lockstep_gaps(a, b, steps=LOCKSTEP_STEPS):
    """Max box gap between two engines' VOT result rows on the videos
    whose skeletons are identical: over the first `steps` tracked frames
    after every init (row 1) and over all tracked frames."""
    from usot_tpu_torch.tools.vot_protocol_bench import skeleton

    early, every = [0.0], [0.0]
    for name in a:
        if skeleton(a[name]) != skeleton(b[name]):
            continue
        since = None
        for ra, rb in zip(a[name], b[name]):
            if isinstance(ra, int):
                since = 0 if ra == 1 else None
                continue
            gap = float(np.max(np.abs(np.subtract(ra, rb))))
            every.append(gap)
            if since is not None:
                since += 1
                if since <= steps:
                    early.append(gap)
    return {"steps": steps, "early_max_px": max(early),
            "early_frames": len(early) - 1, "all_max_px": max(every),
            "all_frames": len(every) - 1}


def run_votbench_tool(weights, device, out_dir=None, card="", videos=6,
                      min_frames=100, max_frames=150, h=360, w=480, chunk=32,
                      batch=8, width=None, channels=None,
                      tol=LOCKSTEP_TOL):
    """Phase 17b: `tools.vot_protocol_bench` (both engines) on `weights`,
    cut to `videos` videos of `min_frames`-`max_frames` frames. Returns
    (record, K1 launches of both engines)."""
    import tempfile

    from usot_tpu_torch.tools import vot_protocol_bench as vb

    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        ckpt = os.path.join(tmp, "weights.pth")
        torch.save(weights, ckpt)
        argv = ["--videos", str(videos), "--min-frames", str(min_frames),
                "--max-frames", str(max_frames), "--h", str(h), "--w",
                str(w), "--chunk", str(chunk), "--batch", str(batch),
                "--ckpt", ckpt, "--root", os.path.join(tmp, "bench"),
                "--device", str(device)]
        if width is not None:
            argv += ["--width", str(width), "--channels", str(channels)]
        reset_launch_counts()  # this run's path starts here
        out = vb.run(vb.parse_args(argv))
        k1 = launch_counts()["K1"]  # read just after the path
    results = out.pop("results")
    frames = {v["name"]: v["n"] for v in vb.gen_benchmark(
        videos, min_frames, max_frames, h, w)[0]}
    for engine in ("batch", "scan"):
        got = {name: len(rows) for name, rows in results[engine].items()}
        check(got == frames, f"votbench {engine}: rows per video {got} "
              f"!= frames {frames}")
    check("spill" in out["batch"]["spilled"],
          f"votbench: the spill video did not spill ({out['batch']})")
    out["lockstep"] = lockstep_gaps(results["batch"], results["scan"])
    same = out["compare"]["skeleton_identical_videos"]
    check(2 * same >= videos, f"votbench: skeletons identical in {same} "
          f"of {videos} videos (fewer than half)")
    check(out["lockstep"]["early_frames"] > 0
          and out["lockstep"]["early_max_px"] <= tol,
          f"votbench: batch vs scan {out['lockstep']} past {tol} px, or "
          "no frame compared")
    out.update(card=card, k1_launches_total=k1)
    print(json.dumps({"votbench": out}), flush=True)
    return out, k1


def run_bench_train_tool(device, iters=3, extra=()):
    """Phase 17c: `tools.bench_train` at its defaults (`extra`: more
    arguments) with `--iters`, in f32 and bf16. Returns ({dtype: record},
    the correlation kernels' launches, all 0)."""
    from usot_tpu_torch.tools import bench_train as bt

    rec, launches = {}, {"K1": 0, "K2": 0, "K3": 0}
    for dtype in ("float32", "bfloat16"):
        reset_launch_counts()  # this run's path starts here
        r = bt.run(bt.parse_args(["--iters", str(iters), "--dtype", dtype,
                                  "--device", str(device), *extra]))
        for k, n in launch_counts().items():  # read just after the path
            launches[k] += n
        for name, ph in r["phases"].items():
            check(np.all(np.isfinite(ph["losses"])),
                  f"bench_train {dtype} {name}: losses {ph['losses']}")
            check(ph["samples_per_s"] > 0 and (
                device.type != "cuda" or ph["peak_memory_bytes"] > 0),
                f"bench_train {dtype} {name}: {ph}")
        rec[dtype] = r
    check(not any(launches.values()),
          f"bench_train launched correlation kernels {launches}")
    print(json.dumps({"bench_train": rec}), flush=True)
    return rec, launches


def run_measuring_tools(weights, device, card="", sha256=None, bench_kw=None,
                        votbench_kw=None, train_kw=None):
    """Phase 17: (a) the bench, (b) the protocol bench, (c) the training
    bench. Returns (record, {path: K1 launches}, bench_train's launches)."""
    t0 = time.perf_counter()
    rec = {"card": card}
    rec["bench"], k1_bench = run_bench_tool(weights, device, card, sha256,
                                            **(bench_kw or {}))
    rec["votbench"], k1_vot = run_votbench_tool(weights, device, card=card,
                                                **(votbench_kw or {}))
    rec["bench_train"], train_launches = run_bench_train_tool(
        device, **(train_kw or {}))
    k1 = {"bench": k1_bench, "votbench": k1_vot}
    if device.type == "cuda":
        check(all(n > 0 for n in k1.values()),
              f"measuring tools: K1 not launched on every path {k1}")
    rec["k1_launches"] = k1
    rec["seconds"] = time.perf_counter() - t0
    return rec, k1, train_launches


# ------------------------------------------------- step attribution tools

# the K1 and K3 calls of one call of each microbench stage that has them
STEP_KERNEL_CALLS = {
    "offline head": {"K1": 2}, "offline+memory head": {"K1": 3},
    "ENC offline+memory head": {"K1": 3}, "ENC+FOLDED head": {"K1": 3},
    "  groupdw multi (fused)": {"K1": 1}, "xcorr shift (1 pair 7x7)": {"K3": 1},
    "FULL STEP (native batched)": {"K1": 3}}
CLIFF_KERNEL_CALLS = {"full": {"K1": 3}, "memhead": {"K1": 3},
                      "xcorr_pair": {"K1": 1}, "groupdw": {"K1": 1}}
BISECT_KERNEL_CALLS = {"chain D": {"K1": 1}, "chain F": {"K1": 3}}


def _finite_positive(label, *values):
    for v in values:
        check(v is not None and np.isfinite(v) and v > 0,
              f"{label}: time {v} is not finite and > 0")


def _stage_checks(tool, rows, device, calls):
    """Every row's times finite and > 0 (device ms on the card), its
    roofline share at most 100 % (above it the count is wrong), and the
    correlation kernels of its stage called (`kernel_calls`, any device)
    and, on the card, launched (`launches`) as `calls` says."""
    for r in rows:
        label = f"{tool} {r['stage'].strip()}"
        if device.type == "cuda":
            _finite_positive(label, r["device_ms"])
            check(r["share_pct"] <= 100.0,
                  f"{label}: roofline share {r['share_pct']:.1f} % > 100 %")
        if "kernel_calls" not in r:
            continue   # an increment of the backbone prefixes
        _finite_positive(label, r["call_ms"])
        want = calls.get(r["stage"], {})
        check(r["kernel_calls"] == want,
              f"{label}: kernel calls {r['kernel_calls']}, expected {want}")
        if device.type == "cuda":
            got = {k: n for k, n in r["launches"].items() if n}
            check(got == want, f"{label}: launches {got}, expected {want}")


def xcorr_7x7_check(device, batch=32, channels=256, dtype=torch.bfloat16):
    """K3 at the microbench's 7x7 kernel (29x29 -> 25x25 of a 31x31
    search feature) against its plain version."""
    from usot_tpu_torch.ops.xcorr import (xcorr_depthwise_pairwise,
                                          xcorr_depthwise_pairwise_reference)

    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((batch, 31, 31, channels), generator=gen).to(device,
                                                                 dtype)
    k = torch.randn((batch, 7, 7, channels), generator=gen).to(device, dtype)
    err, tol = _compare("K3", "7x7 (microbench)", xcorr_depthwise_pairwise(
        x, k), xcorr_depthwise_pairwise_reference(x, k), dtype, device)
    return {"max_abs_err": err, "tol": tol}


def run_step_tools(weights, device, card="", out_dir=None, width=None,
                   channels=None, micro=("--batch", "32", "--iters", "5"),
                   cliff_batches=(32, 48), cliff_stages="full,memhead,backbone",
                   bisect=("--batch", "32", "--iters", "5"),
                   memops=("--frames", "16", "--iters", "3"),
                   lockstep=("--batch", "8", "--frames", "48", "--videos",
                             "8", "--reps", "2"), cliff_iters=5):
    """Phase 18: the step attribution and lockstep tools on `weights`:
    `microbench_step --mfu` (bf16), `cliff_sweep` at `cliff_batches` on
    `cliff_stages`, `cliff_bisect` A-F, `bench_memops`, `bench_lockstep
    --vot --refill`, their JSON records under `out_dir` (default
    `chiprun_out/battery`), then `process_battery` over them. Returns
    (record, {path: launches by kernel})."""
    from usot_tpu_torch.tools import (bench_lockstep, bench_memops,
                                      cliff_bisect, cliff_sweep,
                                      microbench_step, process_battery)

    t0 = time.perf_counter()
    d = out_dir or os.path.join(OUT_DIR, "battery")
    os.makedirs(d, exist_ok=True)
    dev = ["--device", str(device)]
    model = [] if width is None else ["--width", str(width), "--channels",
                                      str(channels)]
    rec, launches = {"card": card}, {}

    reset_launch_counts()  # the microbench's path starts here
    step = microbench_step.run(microbench_step.parse_args(
        [*micro, "--mfu", *dev, *model, "--json",
         os.path.join(d, "step.json")]), weights,
        mfu_path=os.path.join(d, "mfu_inference.json"))
    launches["microbench"] = launch_counts()  # read just after the path
    _stage_checks("microbench", step["mfu_rows"], device, STEP_KERNEL_CALLS)
    for r in step["chunk"]:
        if device.type == "cuda":
            _finite_positive(f"microbench {r['stage']}", r["ms_per_frame"])
    rec["microbench"] = step

    reset_launch_counts()  # the cliff tools' path starts here
    rec["cliff"] = {}
    for b in cliff_batches:
        r = cliff_sweep.run(cliff_sweep.parse_args(
            ["--batch", str(b), "--stages", cliff_stages, "--iters",
             str(cliff_iters), *dev, *model, "--json",
             os.path.join(d, f"cliff_b{b}.json")]), weights)
        _stage_checks(f"cliff B={b}", r["stages"], device,
                      CLIFF_KERNEL_CALLS)
        rec["cliff"][b] = r
    r = cliff_bisect.run(cliff_bisect.parse_args(
        [*bisect, *dev, *model, "--json", os.path.join(
            d, f"bisect_b{bisect[bisect.index('--batch') + 1]}.json")]),
        weights)
    _stage_checks("bisect", r["chains"], device, BISECT_KERNEL_CALLS)
    e, f = (next(c["readout"] for c in r["chains"] if c["stage"] == name)
            for name in ("chain E", "chain F"))
    check(abs(e - f) <= 2.0 ** -7 * max(abs(e), 1.0),
          f"bisect: chain F {f} is not chain E {e}")
    rec["bisect"] = r
    launches["cliff"] = launch_counts()  # read just after the path

    reset_launch_counts()
    mem = bench_memops.run(bench_memops.parse_args(
        [*memops, *dev, "--json", os.path.join(d, "memops.json")]))
    check(mem["correct"], "memops: the formulations disagree")
    for row in mem["rows"]:
        if device.type == "cuda":
            _finite_positive(f"memops {row['gather']}/{row['write']}",
                             row["ms_per_frame"])
    rec["memops"] = mem

    reset_launch_counts()  # the lockstep bench's path starts here
    lock = bench_lockstep.run(bench_lockstep.parse_args(
        ["--vot", "--refill", *lockstep, *dev, *model, "--json",
         os.path.join(d, "lockstep.json")]), weights)
    launches["lockstep_bench"] = launch_counts()  # read just after
    failures = lock["args"]["failures"]
    for rep in lock["vot"]["reps"]:
        check(rep["restarts"] == failures, f"lockstep VOT: {rep['restarts']}"
              f" restarts, {failures} forced failures")
        _finite_positive("lockstep VOT", rep["s"], rep["fps"])
    ref = lock["refill"]
    _finite_positive("lockstep refill", ref["refill_s"], ref["padded_s"])
    check(ref["finite"] and ref["box_gap_px"] <= LOCKSTEP_TOL,
          f"lockstep: refill and padded boxes {ref['box_gap_px']} px apart")
    rec["lockstep"] = lock

    if device.type == "cuda":
        rec["xcorr_7x7"] = xcorr_7x7_check(device)
        check(all(launches[p]["K1"] > 0 for p in launches)
              and launches["microbench"]["K3"] > 0,
              f"step tools: K1/K3 not launched on every path {launches}")
    rec["battery"] = process_battery.main(["--dir", d, *dev])
    rec["seconds"] = time.perf_counter() - t0
    return rec, launches


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

    lap_t = [time.perf_counter()]

    def lap(phases):
        """Print the seconds since the last lap: the script's time limit
        is shared by every phase."""
        now = time.perf_counter()
        print(f"{phases}: {now - lap_t[0]:.1f} s", flush=True)
        lap_t[0] = now

    k1_records = kernel_checks(xcorr_kernel.xcorr_groupdw_cuda,
                               xcorr_groupdw_reference, device)
    single_records = single_checks(
        {"K2": xcorr_kernel.xcorr_depthwise_multi_cuda,
         "K3": xcorr_kernel.xcorr_depthwise_pairwise_cuda},
        {"K2": xcorr_depthwise_multi_reference,
         "K3": xcorr_depthwise_pairwise_reference}, device)
    lap("phases 3-4")

    model, results, slice_k1 = run_slice(device, card=card)
    errs = parity_vs_cpu(model, results, device)
    lap("phase 5")
    tool_records, tool_counts = run_tools()
    lap("phase 6")
    batch_rec, batch_k1 = run_batch_engine(model, device, card=card)
    scan_rec, scan_k1 = run_scan_engine(model, device, card=card)
    lap("phases 7-8")
    proto_rec, proto_k1 = run_protocols(model, device, card=card)
    lap("phase 9")
    bf16_rec, bf16_k1 = run_bf16_engine(model, device, batch_rec, card=card)
    del model
    reset_launch_counts()  # the fixture's path starts here
    fixture_rec = run_fixture(device)
    fixture_k1 = launch_counts()["K1"]  # read just after the path
    lap("phase 11")
    train_rec, train_launches = run_training(device)
    lap("phase 10")
    bf16_train_rec, bf16_train_launches = run_training_bf16(
        device, f32_steps=train_rec["steps"])
    lap("phase 12")
    mining_rec, mining_launches = run_pseudo_labels(device, card=card)
    lap("phase 13")
    # phase 14: the TraX entry point, the evaluation, the one-key chain
    t14 = time.perf_counter()
    trax_rec, trax_k1 = run_trax(device, card=card)
    vot, refill = protocol_datasets()
    eval_rec = score_protocols(os.path.join(OUT_DIR, "protocols"),
                               proto_rec, vot, refill, card=card)
    del vot, refill
    onekey_rec, onekey_k1 = run_onekey(device, card=card)
    entry_rec, entry_k1 = run_entry(device)
    phase14_s = time.perf_counter() - t14
    print(f"phase 14: {phase14_s:.1f} s", flush=True)
    # phase 15: data parallelism, one card standing in for two
    t15 = time.perf_counter()
    sharded_rec, sharded_k1 = run_sharded_engine(
        build_model(device), device, batch_rec, bf16_rec, card=card)
    dp_rec, dp_launches = run_data_parallel_training(
        device, phase10=train_rec["steps"])
    nccl_rec = run_nccl_and_dryrun(device)
    phase15_s = time.perf_counter() - t15
    print(f"phase 15: {phase15_s:.1f} s", flush=True)
    # phase 16: weights the full schedule trains here, end to end
    t16 = time.perf_counter()
    kept = {}
    trained_rec, trained_k1 = run_trained_weights(device, card=card,
                                                  keep=kept)
    phase16_s = time.perf_counter() - t16
    print(f"phase 16: {phase16_s:.1f} s", flush=True)
    # phase 17: the measuring entry points, on phase 16's weights
    weights = kept.pop("weights")
    tools_rec, tools_k1, train_tool_launches = run_measuring_tools(
        weights, device, card=card,
        sha256=trained_rec["schedule"]["checkpoint_sha256"])
    print(f"phase 17: {tools_rec['seconds']:.1f} s", flush=True)
    # phase 18: step attribution and the lockstep benches, same weights
    step_rec, step_launches = run_step_tools(weights, device, card=card)
    del weights
    print(f"phase 18: {step_rec['seconds']:.1f} s", flush=True)
    step_k1 = {path: n["K1"] for path, n in step_launches.items()}

    def pick(records, tag, shape):
        return next(r for r in records
                    if r.get("kernel", "K1") == tag and r["shape"] == shape)

    k1_paths = {"parity_slice": slice_k1, "batch_engine": batch_k1,
                "scan_engine": scan_k1, "protocols": proto_k1,
                "batch_engine_bf16": bf16_k1, "fixture_f32_bf16": fixture_k1,
                "trax": trax_k1, "onekey": onekey_k1, "entry": entry_k1,
                "sharded": sharded_k1, "trained": trained_k1, **tools_k1,
                **step_k1}
    schedule_launches = trained_rec["schedule"]["kernel_launches"]
    k1_line = kernel_line("K1", pick(
        k1_records, "K1", "engine, instance 255, B=32, M=7, C=256, f32"),
        sum(k1_paths.values()), {**k1_paths, "tools": tool_counts["K1"],
                                 "training": train_launches["K1"],
                                 "training_bf16": bf16_train_launches["K1"],
                                 "preprocessing": mining_launches["K1"],
                                 "data_parallel": dp_launches["K1"],
                                 "bench_train": train_tool_launches["K1"],
                                 "training_full_schedule": sum(
                                     c["K1"] for c in
                                     schedule_launches.values())})
    k1_bf16 = pick(k1_records, "K1",
                   "engine, instance 255, B=32, M=7, C=256, bf16")
    k1_line["bf16"] = {k: k1_bf16[k] for k in (
        "shape", "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms")}
    k1_line["bf16"]["launches"] = bf16_k1
    kernels = [
        k1_line,
        kernel_line("K2", pick(single_records, "K2",
                               "B=32, M=7, 29x29 / 5x5, C=256, bf16"),
                    tool_counts["K2"], {
                        "tools": tool_counts["K2"],
                        "training": train_launches["K2"],
                        "training_bf16": bf16_train_launches["K2"],
                        "preprocessing": mining_launches["K2"],
                        "data_parallel": dp_launches["K2"],
                        "bench_train": train_tool_launches["K2"],
                        "training_full_schedule": sum(
                            c["K2"] for c in schedule_launches.values())}),
        kernel_line("K3", pick(single_records, "K3",
                               "B=32, 29x29 / 5x5, C=256, bf16"),
                    tool_counts["K3"] + step_launches["microbench"]["K3"], {
                        "tools": tool_counts["K3"],
                        "microbench": step_launches["microbench"]["K3"],
                        "training": train_launches["K3"],
                        "training_bf16": bf16_train_launches["K3"],
                        "preprocessing": mining_launches["K3"],
                        "data_parallel": dp_launches["K3"],
                        "bench_train": train_tool_launches["K3"],
                        "training_full_schedule": sum(
                            c["K3"] for c in schedule_launches.values())}),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched")
    summary = {"card": card, "kind": kind, "kernels": kernels,
               "ptxas": ptxas,
               "k1_shapes": k1_records, "k2_k3_shapes": single_records,
               "slice": [r for r, _ in results], "gpu_vs_cpu": errs,
               "tools": tool_records, "batch_engine": batch_rec,
               "scan_engine": scan_rec, "protocols": proto_rec,
               "bf16_batch_engine": bf16_rec, "fixture": fixture_rec,
               "training": train_rec, "training_bf16": bf16_train_rec,
               "live_loader": {"alone": bf16_train_rec["live_loader"],
                               "pipelined": bf16_train_rec["pipelined"]},
               "pseudo_labels": mining_rec, "trax": trax_rec,
               "evaluate": eval_rec, "onekey": onekey_rec,
               "entry": entry_rec, "phase14_s": phase14_s,
               "sharded_engine": sharded_rec, "data_parallel": dp_rec,
               "nccl_and_dryrun": nccl_rec, "phase15_s": phase15_s,
               "trained_weights": trained_rec, "phase16_s": phase16_s,
               "measuring_tools": tools_rec, "step_tools": step_rec,
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
