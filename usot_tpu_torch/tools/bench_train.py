"""Training-step throughput on one card: the port's counterpart of the
repo's `tools/bench_train.py`.

    python -m usot_tpu_torch.tools.bench_train [--batch 32] [--mem-batch 8]
        [--mem-num 4] [--iters 10] [--dtype float32|bfloat16]
        [--shards <dir>] [--accum 1] [--remat] [--device cpu] [--json <path>]

Times the two phases of `train/step.py` (naive Siamese at `--batch`,
cycle memory at `--mem-batch` with `--mem-num` memory frames) at the
reference geometry (template 127, search 255, score 25) on the
full-width model (width 64, channels 256), every parameter trainable
(`build_optimizer(..., unfix=True)`), train-mode BN, lambda_1 0.3, lr
0.005, cls_ratio 0.5. Each phase starts from the same seeded weights
(`init_model`, seed 0) and a fresh optimizer, on the repo tool's
synthetic batch (`make_batch`: the same numpy draws in the same order,
NHWC float32). The first step's seconds are recorded apart; then the
least of 3 repetitions of `--iters` steps, each ended by reading the
loss, gives ms per step and samples/s, with
`torch.cuda.max_memory_allocated`. The FLOPs of one step come from
`torch.utils.flop_counter.FlopCounterMode` (aten's forward and backward
ops, counted from their shapes) and are given as a share of the H100
SXM's dense peak for the compute dtype (NVIDIA's data sheet: 67 TFLOP/s
float32 outside the tensor cores, since the port keeps TF32 off; 989
TFLOP/s bf16 on the tensor cores), the peak named beside the figure.
`--shards` also measures samples/s end to end on the cycle-memory phase,
disk through `data/shards.py`'s `ShardLoader` and `device_prefetch` to
the step, beside the device-only rate (a synthetic shard set is written
there first if the directory has none). Training launches none of the
correlation kernels (the plain correlations carry gradients); the record
counts them. Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

LR, CLS_RATIO, LAMBDA_1 = 0.005, 0.5, 0.3
MOMENTUM, WEIGHT_DECAY, LAYERS_LR = 0.9, 1e-4, 0.1
# H100 SXM, dense (NVIDIA's data sheet): the peak of the compute dtype
PEAK_FLOPS = {"float32": (67e12, "H100 SXM FP32 (no tensor cores), "
                                 "data sheet"),
              "bfloat16": (989e12, "H100 SXM BF16 tensor cores, dense, "
                                   "data sheet")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--mem-batch", type=int, default=8)
    ap.add_argument("--mem-num", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="model compute dtype (params stay f32)")
    ap.add_argument("--shards", default=None,
                    help="also measure end-to-end samples/s streaming this "
                    "shard dir (written with synthetic data if missing) "
                    "through device_prefetch and the step")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the backbone's blocks in backward")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                    "one). `cpu` runs on the CPU")
    ap.add_argument("--json", default=None,
                    help="write the record to this path")
    return ap.parse_args(argv)


def make_batch(rng, b, mem, mem_num):
    """The repo tool's synthetic batch (its draws, in its order), NHWC
    float32 numpy."""
    batch = {
        "template": rng.normal(size=(b, 127, 127, 3)).astype(np.float32),
        "search": rng.normal(size=(b, 255, 255, 3)).astype(np.float32),
        "label": (rng.random((b, 25, 25)) > 0.8).astype(np.float32),
        "reg_target": np.abs(rng.normal(
            size=(b, 25, 25, 4)).astype(np.float32)) + 1.0,
        "reg_weight": (rng.random((b, 25, 25)) > 0.7).astype(np.float32),
        "template_bbox": np.tile([3.0, 3.0, 11.0, 11.0], (b, 1))
        .astype(np.float32),
    }
    if mem:
        batch["search_memory"] = rng.normal(
            size=(b, mem_num, 255, 255, 3)).astype(np.float32)
        batch["search_bbox"] = np.tile([5.0, 5.0, 19.0, 19.0], (b, 1)) \
            .astype(np.float32)
    return batch


def make_synthetic_shards(out_dir, n_samples, mem_num, shard_size=64):
    """The repo tool's synthetic cycle-memory shards (transport schema:
    channel-flat uint8 images, `data/shards.py`), seed 0."""
    rng = np.random.default_rng(0)
    os.makedirs(out_dir, exist_ok=True)
    written = sid = 0
    while written < n_samples:
        n = min(shard_size, n_samples - written)
        arrays = {
            "template": rng.integers(0, 255, (n, 127, 127 * 3), np.uint8),
            "search": rng.integers(0, 255, (n, 255, 255 * 3), np.uint8),
            "search_memory": rng.integers(
                0, 255, (n, mem_num, 255, 255 * 3), np.uint8),
            "label": (rng.random((n, 25, 25)) > 0.8).astype(np.float32),
            "reg_target": (np.abs(rng.normal(size=(n, 25, 25, 4))) + 1.0)
            .astype(np.float32),
            "reg_weight": (rng.random((n, 25, 25)) > 0.7)
            .astype(np.float32),
            "template_bbox": np.tile([3.0, 3.0, 11.0, 11.0],
                                     (n, 1)).astype(np.float32),
            "search_bbox": np.tile([5.0, 5.0, 19.0, 19.0],
                                   (n, 1)).astype(np.float32),
        }
        np.savez(os.path.join(out_dir, f"shard_{sid:05d}.npz"), **arrays)
        written += n
        sid += 1
    meta = {"n_samples": n_samples, "shard_size": shard_size,
            "cycle_memory": True, "seed": 0, "n_shards": sid,
            "keys": sorted(arrays)}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


def _fresh_step(model, weights, cycle, args):
    """`model` reset to `weights`, a fresh optimizer, the phase's step."""
    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    model.load_state_dict(weights)
    opt, _ = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR,
                             unfix=True)
    return make_train_step(model, opt, cycle_memory=cycle,
                           stage_bn_train=True, lambda_1=LAMBDA_1,
                           remat=args.remat, accum_steps=args.accum)


def run(args, weights=None):
    """Both phases (and `--shards`) on `args.device`; `weights`: a state
    dict (default: `init_model`'s seed 0). Returns the record."""
    from torch.utils.flop_counter import FlopCounterMode

    from usot_tpu_torch.core.device import f32_numerics, resolve_device
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.ops.xcorr_kernel import launch_counts

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    f32_numerics()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_usot(mem_size=args.mem_num, width=args.width,
                       channels=args.channels, dtype=dtype)
    if weights is None:
        init_model(model, torch.Generator().manual_seed(0), device=device)
    else:
        model.load_state_dict(weights)
        model.to(device)
    weights = {k: t.detach().clone() for k, t in model.state_dict().items()}
    peak, peak_name = PEAK_FLOPS[args.dtype]
    rng = np.random.default_rng(0)
    k_before = launch_counts()

    def sync(metrics):
        return float(metrics["loss"])  # a read of the loss syncs

    rec = {"device": str(device), "dtype": args.dtype,
           "width": args.width, "channels": args.channels,
           "accum": args.accum, "remat": args.remat, "phases": {}}
    for name, cyc, b in (("naive", False, args.batch),
                         ("cycle-memory", True, args.mem_batch)):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 make_batch(rng, b, cyc, args.mem_num).items()}
        step = _fresh_step(model, weights, cyc, args)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        loss = sync(step(batch, LR, CLS_RATIO))
        first_s = time.perf_counter() - t
        print(f"{name}: first step {first_s:.1f}s (loss {loss:.3f})",
              flush=True)
        reps, losses = [], [loss]
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(args.iters):
                metrics = step(batch, LR, CLS_RATIO)
            losses.append(sync(metrics))
            reps.append((time.perf_counter() - t) / args.iters)
        sec = min(reps)
        peak_bytes = torch.cuda.max_memory_allocated(device) if cuda \
            else None
        with FlopCounterMode(display=False) as counter:
            step(batch, LR, CLS_RATIO)
        flops = float(counter.get_total_flops())
        r = {"batch": b, "first_step_s": first_s, "first_loss": loss,
             "losses": losses, "ms_per_step": sec * 1e3,
             "ms_per_step_reps": [x * 1e3 for x in reps],
             "samples_per_s": b / sec,
             "epoch_of_50k_min": 50000 * sec / b / 60,
             "peak_memory_bytes": peak_bytes,
             "flops_per_step": flops,
             "tflops_per_s": flops / sec / 1e12,
             "share_of_peak": flops / sec / peak, "peak": peak_name,
             "peak_tflops": peak / 1e12}
        rec["phases"][name] = r
        print(f"{name}: batch {b}: {sec * 1e3:.1f} ms/step = "
              f"{b / sec:.1f} samples/s (epoch of 50k samples: "
              f"{r['epoch_of_50k_min']:.1f} min)"
              + (f", peak {peak_bytes / 1e9:.2f} GB" if cuda else ""),
              flush=True)
        print(f"{name}: aten-counted {flops / 1e12:.3f} TFLOP/step -> "
              f"{r['tflops_per_s']:.1f} TFLOP/s = "
              f"{100 * r['share_of_peak']:.1f}% of the {peak_name} peak "
              f"({peak / 1e12:.0f} TFLOP/s)", flush=True)
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{name}: non-finite loss {losses}")
    k_after = launch_counts()
    rec["kernel_launches"] = {k: k_after[k] - k_before[k] for k in k_after}
    if args.shards:
        rec["shards"] = end_to_end_shards(
            args, model, weights, device,
            rec["phases"]["cycle-memory"]["samples_per_s"])
    return rec


def end_to_end_shards(args, model, weights, device, device_only):
    """Samples/s of the cycle-memory phase from disk: `ShardLoader` ->
    `device_prefetch` -> the step, beside the device-only rate."""
    from usot_tpu_torch.data.shards import (ShardLoader, device_prefetch,
                                            read_meta)

    b = args.mem_batch
    if read_meta(args.shards) is None:
        n = max(4 * b, 4 * b * ((args.iters + 3) // 4))
        print(f"building synthetic shards ({n} samples) in {args.shards}",
              flush=True)
        make_synthetic_shards(args.shards, n, args.mem_num,
                              shard_size=2 * b)
    step = _fresh_step(model, weights, True, args)
    loader = ShardLoader(args.shards, b)
    # the first step outside the timed epoch
    first = next(iter(loader))
    float(step({k: torch.from_numpy(v).to(device) for k, v in first.items()},
               LR, CLS_RATIO)["loss"])
    n_steps = 0
    t = time.perf_counter()
    for batch in device_prefetch(loader, device):
        metrics = step(batch, LR, CLS_RATIO)
        n_steps += 1
    float(metrics["loss"])
    wall = time.perf_counter() - t
    rate = n_steps * b / wall
    print(f"end-to-end shards: {n_steps} steps of {b} in {wall:.1f}s = "
          f"{rate:.1f} samples/s ({100 * rate / device_only:.0f}% of "
          f"device-only {device_only:.1f}/s)", flush=True)
    return {"steps": n_steps, "batch": b, "wall_s": wall,
            "samples_per_s": rate, "device_only_samples_per_s": device_only,
            "share_of_device_only": rate / device_only}


def main(argv=None):
    args = parse_args(argv)
    rec = run(args)
    if args.device is None or args.device.startswith("cuda"):
        from usot_tpu_torch.tools.timing import card_line

        rec["card"] = card_line()
    line = json.dumps({"bench_train": rec})
    print(line, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
