"""The full 30-epoch staged schedule, run three times through the real
trainer: unbroken, killed with SIGKILL in the middle of an epoch, and
resumed. The port's counterpart of the repo's
`tools/train_full_schedule.py`, with its arguments and defaults.

    python -m usot_tpu_torch.tools.train_full_schedule [--end-epoch 30]
        [--kill 16] [--width 64] [--channels 256] [--samples 32]
        [--batch 8] [--videos 12] [--device cpu]

The schedule is the reference recipe's (ref: scripts/train_usot.py:
324-361, experiments/train/USOT.yaml:8-51): naive Siamese until the
memory epoch (6), cycle memory after; the backbone unfrozen and the
optimizer rebuilt at epoch 10; warmup over 5 epochs, then log decay;
lambda_1 / cls_ratio shifts at 10 and 20; checkpoints from epoch 5.

The dataset is `synthetic_crop511.gen_dataset`'s, held in memory; one
shard cache for epochs 1..END is built from it in this process by
`cli.make_shards.main(argv, reader)`, so the three runs read the same
batches in the same order. Each run is a child process,
`python -m usot_tpu_torch.tools.train_full_schedule --child [...] --
<cli.train argv>`, which sets deterministic mode
(`CUBLAS_WORKSPACE_CONFIG=:4096:8`, `torch.use_deterministic_algorithms
(True)`, `cudnn.benchmark=False`) and calls `cli.train.main(argv)`:
  1. unbroken: epochs 1..END;
  2. interrupted: the same, SIGKILLed to its process group once
     `train_record.json` shows epoch KILL-1 and epoch KILL has begun
     (the child holds after epoch KILL's first step, so the kill lands
     inside that epoch on a fast card as on a slow CPU);
  3. resumed: `--resume checkpoint_e{KILL-1}.pth`, into the same
     directories, to END.
The checks are the repo tool's: the interrupted prefix and the resumed
epochs against the unbroken run (held at 0.0: deterministic mode makes
the runs bitwise), loss lengths equal, and the schedule's transitions.
The children also log each step's time and each checkpoint's save
time and bytes. The record (`TRAIN_r05.json`'s fields, plus the device,
the torch version and the deterministic settings) goes to `--out`,
under `--root` (default `var/full_schedule_torch/`). Exit code 1 when a
check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DETERMINISTIC = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8",
                 "use_deterministic_algorithms": True,
                 "cudnn.benchmark": False}
HOLD_S = 900  # the longest a held child waits for its kill


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--end-epoch", type=int, default=30)
    ap.add_argument("--kill", type=int, default=16,
                    help="epoch to SIGKILL the interrupted run during")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--samples", type=int, default=32,
                    help="samples per epoch")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="the children's torch device (default: the GPU)")
    ap.add_argument("--root", default="var/full_schedule_torch")
    ap.add_argument("--out", default=None,
                    help="the record (default <root>/train_full_schedule"
                    ".json)")
    return ap.parse_args(argv)


def write_cfg(root, tag, crop_dir, ann_path, args, end_epoch):
    """The repo tool's config, as JSON (which either package's
    `update_config` reads, PyYAML or not)."""
    cfg = {
        "USOT": {
            "OUTPUT_DIR": os.path.join(root, tag, "log"),
            "CHECKPOINT_DIR": os.path.join(root, tag, "snapshot"),
            "WORKERS": 2,
            "PRINT_FREQ": 50,
            "TRAIN": {
                "WIDTH": args.width,
                "CHANNELS": args.channels,
                "START_EPOCH": 1,
                "END_EPOCH": end_epoch,
                "BATCH": args.batch,
                "BATCH_STAGE_2": args.batch,
                # the reference recipe's transition epochs, verbatim
                # (experiments/train/USOT.yaml:8-51)
                "MEMORY_EPOCH": 6,
                "UNFIX_EPOCH": 10,
                "MEMORY_NUM": 4,
                "PRETRAIN": "nonexistent.model",
                "WHICH_USE": ["GOT10K"],
                "WARMUP": {
                    "IFNOT": True, "TYPE": "step", "EPOCH": 5,
                    "KWARGS": {"start_lr": 0.001, "end_lr": 0.005,
                               "step": 1},
                },
                "LR": {"TYPE": "log",
                       "KWARGS": {"start_lr": 0.005, "end_lr": 0.0001}},
                "LAMBDA_SHIFT_EPOCHS": [0, 10, 20],
                "LAMBDA_1_LIST": [0.3, 0.275, 0.25],
                "CLS_RATIO_SHIFT_EPOCHS": [0, 10, 20],
                "CLS_RATIOS": [0.6, 0.5, 0.4],
            },
            "DATASET": {
                "GOT10K": {
                    "PATH": crop_dir + "/",
                    "ANNOTATION": ann_path,
                    "USE": args.samples,
                },
            },
        }
    }
    path = os.path.join(root, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


# ------------------------------------------------------------------ child

def child(argv, hold_epoch=None, marker=None, timing=None):
    """`cli.train.main(argv)` in deterministic mode. timing: a JSON-lines
    file that gets, at each epoch's checkpoint, the epoch's step times
    (ms, each ended by the loss's read), the save's ms and bytes and the
    correlation kernels' launch counts so far.
    hold_epoch: after that epoch's first step, write `marker` and wait
    (at most HOLD_S) to be killed."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = \
        DETERMINISTIC["CUBLAS_WORKSPACE_CONFIG"]
    import torch

    from usot_tpu_torch.cli import train as cli_train
    from usot_tpu_torch.ops.xcorr_kernel import launch_counts

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    epoch_of = {"now": None}
    steps_ms: list = []
    loader, make_step, save = (cli_train.epoch_loader,
                               cli_train.make_train_step,
                               cli_train.save_model_epoch)

    def epoch_loader(cfg, args, epoch, *a, **kw):
        epoch_of["now"] = epoch
        return loader(cfg, args, epoch, *a, **kw)

    def make_train_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(*sa, **skw):
            t0 = time.perf_counter()
            out = step(*sa, **skw)
            float(out["loss"])  # the loop reads it next: the step's end
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            if epoch_of["now"] == hold_epoch:
                with open(marker, "w") as f:
                    f.write(str(hold_epoch))
                time.sleep(HOLD_S)
                raise SystemExit(f"held {HOLD_S} s in epoch {hold_epoch} "
                                 "and was not killed")
            return out
        return timed

    def save_model_epoch(directory, model, optimizer, epoch, *a, **kw):
        t0 = time.perf_counter()
        path = save(directory, model, optimizer, epoch, *a, **kw)
        save_ms = (time.perf_counter() - t0) * 1e3
        if timing:
            with open(timing, "a") as f:
                f.write(json.dumps({
                    "epoch": epoch, "step_ms": list(steps_ms),
                    "save_ms": save_ms if path else None,
                    "save_bytes": os.path.getsize(path) if path else None,
                    "launches": launch_counts()}) + "\n")
        steps_ms.clear()
        return path

    cli_train.epoch_loader = epoch_loader
    cli_train.make_train_step = make_train_step
    cli_train.save_model_epoch = save_model_epoch
    cli_train.main(argv)


# ----------------------------------------------------------------- parent

def _child_cmd(cfg_path, shards, args, timing, resume=None, hold=None):
    cmd = [sys.executable, "-m", "usot_tpu_torch.tools.train_full_schedule",
           "--child", "--timing", timing]
    if hold:
        cmd += ["--hold-epoch", str(hold[0]), "--marker", hold[1]]
    cmd += ["--", "--cfg", cfg_path, "--devices", "1", "--shards", shards]
    if args.device:
        cmd += ["--device", args.device]
    if resume:
        cmd += ["--resume", resume]
    return cmd


def run_train(cfg_path, shards, args, timing, resume=None):
    cmd = _child_cmd(cfg_path, shards, args, timing, resume)
    print("==>", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=REPO)
    return time.perf_counter() - t0


def run_train_killed(cfg_path, shards, args, timing, record_path):
    """Launch the trainer and SIGKILL its process group while epoch
    `args.kill` is in flight: once the record shows epoch kill-1 (its
    checkpoint saved) and the child has taken epoch kill's first step."""
    kill_epoch = args.kill
    marker = os.path.join(os.path.dirname(record_path), "holding")
    if os.path.exists(marker):
        os.remove(marker)
    cmd = _child_cmd(cfg_path, shards, args, timing,
                     hold=(kill_epoch, marker))
    print("==> (to be killed mid-epoch %d)" % kill_epoch, " ".join(cmd),
          flush=True)
    proc = subprocess.Popen(cmd, cwd=REPO, start_new_session=True)
    t0 = time.perf_counter()
    killed_at = None
    try:
        while proc.poll() is None:
            time.sleep(0.2)
            try:
                with open(record_path) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # not written yet, or being rewritten
            if str(kill_epoch - 1) in rec.get("epochs", {}) \
                    and os.path.exists(marker):
                killed_at = time.perf_counter() - t0
                os.killpg(proc.pid, signal.SIGKILL)
                break
        proc.wait()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if killed_at is None:
        raise RuntimeError(
            f"train exited (rc={proc.returncode}) before reaching "
            f"epoch {kill_epoch}")
    print(f"    killed after {killed_at:.1f}s (rc={proc.returncode})",
          flush=True)
    return killed_at


def load_record(root, tag):
    with open(os.path.join(root, tag, "log", "train_record.json")) as f:
        return json.load(f)


def _timing(path):
    with open(path) as f:
        return {int(r["epoch"]): r for r in map(json.loads, f)}


def _last_launches(path):
    """A child's correlation-kernel launches up to its last checkpoint."""
    logged = _timing(path)
    return logged[max(logged)]["launches"]


def transitions(epochs, end_epoch):
    """The repo tool's schedule checks on a run's `epochs` record."""
    return {
        "memory_epoch_6": (not epochs["5"]["cycle_memory"]
                           and epochs["6"]["cycle_memory"]),
        "unfix_epoch_10": (not epochs["9"]["unfix"]
                           and epochs["10"]["unfix"]),
        "warmup_rises": epochs["1"]["lr"] < epochs["5"]["lr"],
        "decay_falls": epochs["6"]["lr"] > epochs[str(end_epoch)]["lr"],
        "lambda_shifts": sorted({e["lambda_1"] for e in epochs.values()},
                                reverse=True),
        "cls_ratio_shifts": sorted({e["cls_ratio"]
                                    for e in epochs.values()},
                                   reverse=True),
        "ckpt_from_epoch_5": all(
            (epochs[str(e)]["checkpoint"] is not None) == (e >= 5)
            for e in range(1, end_epoch + 1)),
    }


def _max_delta(a_epochs, b_epochs, epochs):
    delta = 0.0
    for e in epochs:
        a = a_epochs[str(e)]["losses"]
        b = b_epochs[str(e)]["losses"]
        if len(a) != len(b):
            raise RuntimeError(f"epoch {e}: {len(a)} vs {len(b)} losses")
        delta = max(delta, max(abs(x - y) for x, y in zip(a, b)))
    return delta


def _stage(rec):
    if not rec["cycle_memory"]:
        return "naive"
    return "cycle_unfrozen" if rec["unfix"] else "cycle_frozen"


def step_times(epochs, timing):
    """ms per step by stage (median over the run's steps, the leg's very
    first step apart) and the checkpoints' bytes and save ms."""
    by_stage: dict = {}
    first = min(timing)
    for e, t in sorted(timing.items()):
        steps = t["step_ms"][1:] if e == first else t["step_ms"]
        by_stage.setdefault(_stage(epochs[str(e)]), []).extend(steps)
    saves = [t for t in timing.values() if t["save_ms"] is not None]
    return {
        "ms_per_step": {k: statistics.median(v)
                        for k, v in by_stage.items() if v},
        "first_step_ms": timing[first]["step_ms"][0],
        "checkpoint": {
            "count": len(saves),
            "bytes": max(t["save_bytes"] for t in saves) if saves else None,
            "save_ms_median": (statistics.median(t["save_ms"] for t in saves)
                               if saves else None)},
    }


def _device_line(device):
    if device == "cpu":
        return "cpu"
    from usot_tpu_torch.tools.timing import card_line
    return card_line()


def build_shards(args):
    """The dataset in memory and the shard cache of epochs 1..END under
    `--root`. Returns (root, crop_dir, ann_path, shards, seconds)."""
    from usot_tpu_torch.cli.make_shards import main as make_shards
    from usot_tpu_torch.tools.synthetic_crop511 import gen_dataset

    root = os.path.join(REPO, args.root)
    os.makedirs(root, exist_ok=True)
    crop_dir, ann_path, reader = gen_dataset(root, args.videos)
    shards = os.path.join(root, "shards")
    cfg_shards = write_cfg(root, "shardcfg", crop_dir, ann_path, args,
                           args.end_epoch)
    t0 = time.perf_counter()
    make_shards(["--cfg", cfg_shards, "--out", shards,
                 "--epochs", f"1-{args.end_epoch}",
                 "--samples", str(args.samples), "--workers", "4"], reader)
    return root, crop_dir, ann_path, shards, time.perf_counter() - t0


def run(args):
    """The three runs and their checks. Returns the record (its
    `failures`: the checks that failed, empty when all held)."""
    import torch

    from usot_tpu_torch.core.device import resolve_device

    resolve_device(args.device)  # raises before any work without a GPU
    if args.kill - 1 < 5:
        raise ValueError(f"--kill {args.kill}: checkpoints start at "
                         "epoch 5, the resume needs epoch kill-1's")
    root, crop_dir, ann_path, shards, shard_s = build_shards(args)

    timing = {tag: os.path.join(root, f"timing_{tag}.jsonl")
              for tag in ("unbroken", "interrupted", "resumed")}
    for path in timing.values():
        if os.path.exists(path):
            os.remove(path)
    for tag in ("unbroken", "interrupted"):  # an earlier run's logs
        shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
    cfg_full = write_cfg(root, "unbroken", crop_dir, ann_path, args,
                         args.end_epoch)
    full_s = run_train(cfg_full, shards, args, timing["unbroken"])
    unbroken = load_record(root, "unbroken")

    cfg_int = write_cfg(root, "interrupted", crop_dir, ann_path, args,
                        args.end_epoch)
    int_record = os.path.join(root, "interrupted", "log",
                              "train_record.json")
    killed_at = run_train_killed(cfg_int, shards, args,
                                 timing["interrupted"], int_record)
    interrupted = load_record(root, "interrupted")
    failures = []
    done = sorted(map(int, interrupted["epochs"]))
    if done != list(range(1, args.kill)):
        failures.append(f"interrupted run completed {done}, expected "
                        f"1..{args.kill - 1}")
    ckpt = os.path.join(root, "interrupted", "snapshot",
                        f"checkpoint_e{args.kill - 1}.pth")
    if not os.path.exists(ckpt):
        raise RuntimeError(f"no checkpoint to resume from: {ckpt}")

    # the resume continues in the same output directories
    resume_s = run_train(cfg_int, shards, args, timing["resumed"],
                         resume=ckpt)
    resumed = load_record(root, "interrupted")
    got = sorted(map(int, resumed["epochs"]))
    if got != list(range(args.kill, args.end_epoch + 1)):
        failures.append(f"resumed run completed {got}, expected "
                        f"{args.kill}..{args.end_epoch}")

    prefix_delta = _max_delta(unbroken["epochs"], interrupted["epochs"],
                              range(1, args.kill))
    resume_delta = _max_delta(unbroken["epochs"], resumed["epochs"],
                              range(args.kill, args.end_epoch + 1))
    if prefix_delta != 0.0:
        failures.append(f"interrupted prefix delta {prefix_delta}")
    if resume_delta != 0.0:
        failures.append(f"resume delta {resume_delta}")

    epochs = unbroken["epochs"]
    checks = transitions(epochs, args.end_epoch)
    for key, ok in checks.items():
        want = ([0.3, 0.275, 0.25] if key == "lambda_shifts" else
                [0.6, 0.5, 0.4] if key == "cls_ratio_shifts" else True)
        if ok != want:
            failures.append(f"transition {key}: {ok}")
    first_last = [epochs["1"]["loss_avg"],
                  epochs[str(args.end_epoch)]["loss_avg"]]

    out = {
        "what": "full staged schedule on the port + mid-epoch kill -9 + "
                "resume (ref: scripts/train_usot.py:324-361)",
        "device": _device_line(args.device),
        "torch": torch.__version__,
        "deterministic": DETERMINISTIC,
        "model": {"width": args.width, "channels": args.channels,
                  "batch": args.batch, "samples_per_epoch": args.samples},
        "end_epoch": args.end_epoch,
        "kill_epoch": args.kill,
        "transitions": checks,
        "interrupted_prefix_max_delta": prefix_delta,
        "resume_max_loss_delta": resume_delta,
        "resume_exact": resume_delta == 0.0,
        "epochs": {e: {k: v for k, v in rec.items() if k != "losses"}
                   for e, rec in epochs.items()},
        "losses": {leg: {e: r["losses"] for e, r in rec["epochs"].items()}
                   for leg, rec in (("unbroken", unbroken),
                                    ("interrupted", interrupted),
                                    ("resumed", resumed))},
        "loss_first_last": first_last,
        "loss_falls": first_last[1] < first_last[0],
        "wall_s": {"shards": shard_s,
                   "unbroken": full_s,
                   "interrupted_until_kill": killed_at,
                   "resumed": resume_s},
        "shards": {"samples": args.samples * args.end_epoch,
                   "samples_per_s": args.samples * args.end_epoch / shard_s},
        "unbroken_steps": step_times(epochs, _timing(timing["unbroken"])),
        "kernel_launches": {leg: _last_launches(path)
                            for leg, path in timing.items()},
        "checkpoint_e_end": os.path.join(
            root, "unbroken", "snapshot", f"checkpoint_e{args.end_epoch}.pth"),
        "failures": failures,
    }
    path = args.out or os.path.join(root, "train_full_schedule.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"resume_exact": out["resume_exact"],
                      "interrupted_prefix_max_delta": prefix_delta,
                      "resume_max_loss_delta": resume_delta,
                      "loss_first_last": first_last,
                      "failures": failures}), flush=True)
    print("wrote", path, flush=True)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        cp = argparse.ArgumentParser()
        cp.add_argument("--child", action="store_true")
        cp.add_argument("--timing", default=None)
        cp.add_argument("--hold-epoch", type=int, default=None)
        cp.add_argument("--marker", default=None)
        split = argv.index("--")
        opts = cp.parse_args(argv[:split])
        child(argv[split + 1:], opts.hold_epoch, opts.marker, opts.timing)
        return 0
    return 1 if run(parse_args(argv))["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
