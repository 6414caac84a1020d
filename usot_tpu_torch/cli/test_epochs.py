"""Epoch-sweep benchmark testing of the port (ref: scripts/
test_epochs_usot.py).

    python -m usot_tpu_torch.cli.test_epochs --start_epoch 5 \
        --end_epoch 6 --dataset OTB2015 [--processes 2] [--device cpu]

Counterpart of `usot_tpu/cli/test_epochs.py`: runs
`python -m usot_tpu_torch.cli.test --epoch_test True` once per
checkpoint of the epoch range found under `--snapshot_dir` (the port's
`checkpoint_eN.pth`, else `usot_tpu`'s `checkpoint_eN.ckpt`), one after
another or `--processes` at a time, with the pass-through flags (and
`--device`) forwarded. `main(argv, reader=...)` runs the tests in this
process instead, its frames read by `reader` (frames held in memory).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

MODULE = "usot_tpu_torch.cli.test"
PASSTHROUGH = ("dataset_root", "result_dir", "mem_size", "engine", "width",
               "channels", "device")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="epoch sweep test")
    p.add_argument("--arch", default="USOT")
    p.add_argument("--start_epoch", type=int, default=10)
    p.add_argument("--end_epoch", type=int, default=30)
    p.add_argument("--dataset", default="VOT2018")
    p.add_argument("--snapshot_dir", default="var/snapshot")
    p.add_argument("--processes", type=int, default=1)
    # passthrough to cli.test (the onekey pipeline points these at its
    # own synthetic benchmark + result dirs)
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--result_dir", default=None)
    p.add_argument("--mem_size", type=int, default=None)
    p.add_argument("--engine", default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device of every test run (default: the "
                   "GPU; the runs raise without one). `cpu` runs on the "
                   "CPU")
    return p.parse_args(argv)


def checkpoint_of(snapshot_dir: str, epoch: int):
    """The epoch's checkpoint: the port's `.pth`, else a `.ckpt`; None
    where there is neither."""
    for ext in (".pth", ".ckpt"):
        path = os.path.join(snapshot_dir, f"checkpoint_e{epoch}{ext}")
        if os.path.exists(path):
            return path
    return None


def commands(args):
    """The test command of each epoch with a checkpoint."""
    passthrough = []
    for flag in PASSTHROUGH:
        val = getattr(args, flag)
        if val is not None:
            passthrough += [f"--{flag}", str(val)]
    cmds = []
    for e in range(args.start_epoch, args.end_epoch + 1):
        ckpt = checkpoint_of(args.snapshot_dir, e)
        if ckpt is None:
            continue
        cmds.append([sys.executable, "-m", MODULE,
                     "--arch", args.arch, "--resume", ckpt,
                     "--dataset", args.dataset, "--epoch_test", "True",
                     *passthrough])
    return cmds


def main(argv=None, reader=None):
    args = parse_args(argv)
    cmds = commands(args)
    if reader is not None:
        from usot_tpu_torch.cli import test

        for cmd in cmds:
            test.main(cmd[3:], reader=reader)
        return
    if args.processes <= 1:
        for cmd in cmds:
            _report(cmd, subprocess.run(cmd, check=False).returncode)
    else:
        running = []
        for cmd in cmds:
            running.append((cmd, subprocess.Popen(cmd)))
            if len(running) >= args.processes:
                done, proc = running.pop(0)
                _report(done, proc.wait())
        for cmd, proc in running:
            _report(cmd, proc.wait())


def _report(cmd, rc):
    """An epoch's failed test does not stop the sweep (as in the JAX
    CLI); it is reported."""
    if rc:
        print(f"test_epochs: {' '.join(cmd)} exited with {rc}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
