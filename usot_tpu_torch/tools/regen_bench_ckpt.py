"""The trained full-width checkpoint, made again: the unbroken run of
`train_full_schedule` alone (the same config writer, shard cache and
seeds, so the same checkpoint), without the kill and the resume. The
port's counterpart of the repo's `tools/regen_bench_ckpt.py`.

    python -m usot_tpu_torch.tools.regen_bench_ckpt [--end-epoch 30]
        [--device cpu]

It leaves `var/full_schedule_torch/unbroken/snapshot/checkpoint_e30.pth`:
30 epochs at full width (64/256, B=8, 32 samples per epoch) on the
synthetic crop511 dataset. That file is the `BENCH_CKPT` of the GPU
bench to come, and the default `--ckpt` of `accuracy_parity_run`.
"""
from __future__ import annotations

import argparse
import os

from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.tools.train_full_schedule import (build_shards,
                                                      parse_args as
                                                      schedule_args,
                                                      run_train, write_cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--end-epoch", type=int, default=30)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--device", default=None)
    ap.add_argument("--root", default="var/full_schedule_torch")
    mine = ap.parse_args(argv)
    args = schedule_args([])
    for k, v in vars(mine).items():
        setattr(args, k, v)

    resolve_device(args.device)  # raises before any work without a GPU
    root, crop_dir, ann_path, shards, shard_s = build_shards(args)
    print(f"shards in {shard_s:.1f}s", flush=True)
    cfg_full = write_cfg(root, "unbroken", crop_dir, ann_path, args,
                         args.end_epoch)
    timing = os.path.join(root, "timing_unbroken.jsonl")
    if os.path.exists(timing):
        os.remove(timing)
    train_s = run_train(cfg_full, shards, args, timing)
    ckpt = os.path.join(root, "unbroken", "snapshot",
                        f"checkpoint_e{args.end_epoch}.pth")
    if not os.path.exists(ckpt):
        raise RuntimeError(f"no checkpoint at {ckpt}")
    print(f"train in {train_s:.1f}s -> {ckpt}", flush=True)
    return ckpt


if __name__ == "__main__":
    main()
