"""Pre-augment training epochs into streaming shards: the port's copy of
`usot_tpu/cli/make_shards.py` over `data/shards.write_shards`, in the
same format, so either package's trainer reads either's shard sets.

The reference hides its input-pipeline cost behind 32 DataLoader worker
processes (ref: scripts/train_usot.py:337-344). This CLI materialises
the same augmented samples offline, so the training loop's host work per
step is a disk read and a slice.

Epoch subdirectories (epoch_XXX) hold independent shard sets: the
dataset re-picks and re-augments per epoch seed exactly as the live
loader does (USOTDataset(seed=epoch)).

Usage:
  python -m usot_tpu_torch.cli.make_shards \\
      --cfg experiments/train/USOT.yaml --out var/shards \\
      --epochs 1-30 [--samples N] [--workers 4]
"""
from __future__ import annotations

import argparse
import os

from usot_tpu_torch.config.defaults import load_config
from usot_tpu_torch.data.dataset import USOTDataset
from usot_tpu_torch.data.shards import epoch_dir, read_meta, write_shards


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="build training shards")
    p.add_argument("--cfg", default="experiments/train/USOT.yaml")
    p.add_argument("--out", default="var/shards")
    p.add_argument("--epochs", default="1",
                   help="epoch or inclusive range, e.g. '7' or '1-30'")
    p.add_argument("--samples", type=int, default=None,
                   help="samples per epoch (default: dataset length)")
    p.add_argument("--shard-size", type=int, default=256)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--force", action="store_true",
                   help="rebuild epochs that already have meta.json")
    return p.parse_args(argv)


def main(argv=None, reader=None):
    """Build the shard sets of `--epochs`; `reader(path)` gives a frame's
    BGR uint8 array (default: the dataset's own, which decodes files):
    frames held in memory on a machine with no image codec."""
    args = parse_args(argv)
    cfg = load_config(args.cfg if os.path.exists(args.cfg) else None)
    tc = cfg.USOT.TRAIN
    lo, _, hi = args.epochs.partition("-")
    for epoch in range(int(lo), int(hi or lo) + 1):
        out = epoch_dir(args.out, epoch)
        if not args.force and read_meta(out) is not None:
            print(f"epoch {epoch}: exists, skipping ({out})")
            continue
        dataset = USOTDataset(cfg, seed=epoch, reader=reader)
        dataset.cycle_memory = epoch >= tc.MEMORY_EPOCH
        meta = write_shards(dataset, out, n_samples=args.samples,
                            shard_size=args.shard_size,
                            workers=args.workers, log_every=10)
        print(f"epoch {epoch}: {meta['n_samples']} samples "
              f"in {meta['n_shards']} shards -> {out} "
              f"(cycle_memory={meta['cycle_memory']})")


if __name__ == "__main__":
    main()
