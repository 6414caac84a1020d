"""One-key pipeline of the port: preprocess -> train -> epoch-sweep test
-> eval (ref: scripts/onekey_usot.py:29-66; preprocessing chain:
scripts/preprocessing/parse_<dataset>.py -> par_crop -> gen_json).

    python -m usot_tpu_torch.cli.onekey --cfg <yaml> [--device cpu]

Counterpart of `usot_tpu/cli/onekey.py`. Each stage is a subprocess of
the port's CLI (`usot_tpu_torch.cli.{parse_flow,train,test_epochs,
evaluate}`), driven by one YAML config, so the whole L1->L7 chain (raw
videos -> flow pseudo-boxes -> crop511/train.json -> training ->
benchmark runs -> AUC) is a single command. Every stage that runs the
network gets `--device` (default the GPU; raises without one).
`main(argv, cfg=..., run_stage=...)` takes the config as a dict in
place of the file and a `run_stage(stage, argv)` in place of the
subprocess (`in_process`: the stages in this process, frames held in
memory). PyYAML is imported only to read or write a config file.

Config keys used (all under USOT:):
  PREPROCESS: ISTRUE, DATA_DIR, OUTPUT_DIR, DATASET [, MAX_FRAMES, LIMIT,
              INSTANCE_SIZE, KEEP_ALL]
  TRAIN:      ISTRUE (plus the normal training keys; point
              DATASET.<X>.PATH/ANNOTATION at PREPROCESS.OUTPUT_DIR).
              WIDTH/CHANNELS, where given, are passed to the test runs
  TEST:       ISTRUE, DATA, START_EPOCH, END_EPOCH [, DATASET_ROOT,
              RESULT_DIR, ENGINE, MEM_SIZE, PROCESSES]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from usot_tpu_torch.core.device import resolve_device

# Per-stage wall-clock seconds of the last main() run (also written to
# <OUTPUT_DIR>/onekey_stages.json) — the machine-readable record of the
# L1->L7 chain (ref: scripts/onekey_usot.py logs stage boundaries).
STAGE_TIMES: dict = {}

MODULES = {"preprocess": "parse_flow", "train": "train",
           "test_epochs": "test_epochs", "evaluate": "evaluate"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="preprocess+train+test+eval")
    p.add_argument("--cfg", default="experiments/train/USOT.yaml")
    p.add_argument("--dataset_dir", default="datasets_test",
                   help="benchmark root for evaluation (overridden by "
                   "TEST.DATASET_ROOT)")
    p.add_argument("--device", default=None,
                   help="torch device of every stage that runs the "
                   "network (default: the GPU; raises without one). `cpu` "
                   "runs on the CPU")
    return p.parse_args(argv)


def stage_command(stage: str, argv) -> list:
    """The subprocess command of a stage."""
    return [sys.executable, "-m", f"usot_tpu_torch.cli.{MODULES[stage]}",
            *argv]


def run_subprocess(stage: str, argv) -> None:
    cmd = stage_command(stage, argv)
    print("==>", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def in_process(cfg: dict, reader=None, writer=None):
    """A `run_stage` that runs each stage's CLI in this process: frames
    read by `reader(path)` and crops stored by `writer(path, image)`
    (default `data.imageio`'s), the trainer on `cfg` (the config dict)."""
    def run_stage(stage, argv):
        if stage == "preprocess":
            from usot_tpu_torch.cli import parse_flow
            parse_flow.main(argv, reader=reader, writer=writer)
        elif stage == "train":
            from usot_tpu_torch.cli import train
            from usot_tpu_torch.config.defaults import (default_config,
                                                        update_config_dict)
            args = train.parse_args(argv)
            train.train(update_config_dict(default_config(), cfg), args,
                        args.device, reader=reader)
        elif stage == "test_epochs":
            from usot_tpu_torch.cli import test_epochs
            test_epochs.main(argv, reader=reader)
        else:
            from usot_tpu_torch.cli import evaluate
            evaluate.main(argv)
    return run_stage


def _run(run_stage, stage, argv):
    t0 = time.perf_counter()
    run_stage(stage, argv)
    STAGE_TIMES[stage] = round(time.perf_counter() - t0, 3)


def _read_cfg(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _write_cfg(cfg: dict, path: str) -> None:
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def main(argv=None, cfg=None, run_stage=None):
    """The chain of `--cfg` (or `cfg`, the config's contents as a dict:
    {"USOT": {...}}); each stage through `run_stage(stage, argv)`
    (default: a subprocess of the stage's CLI)."""
    args = parse_args(argv)
    device = str(resolve_device(args.device))
    cfg_path = args.cfg
    given = cfg is not None
    if not given:
        cfg = _read_cfg(cfg_path)
    c = cfg["USOT"]
    log_dir = c.get("OUTPUT_DIR", "var/log")
    os.makedirs(log_dir, exist_ok=True)
    if given:
        # the trainer's file: written for its subprocess, named for a
        # `run_stage` (which has the dict)
        cfg_path = os.path.join(log_dir, "onekey.yaml")
    if run_stage is None:
        run_stage = run_subprocess
        if given:
            _write_cfg(cfg, cfg_path)
    STAGE_TIMES.clear()

    pre = c.get("PREPROCESS", {})
    if pre.get("ISTRUE", False):
        cmd = ["--data_dir", pre["DATA_DIR"],
               "--output_dir", pre["OUTPUT_DIR"],
               "--dataset", pre.get("DATASET", "got10k")]
        for key, flag in (("MAX_FRAMES", "--max_frames"),
                          ("LIMIT", "--limit"),
                          ("INSTANCE_SIZE", "--instance_size")):
            if key in pre:
                cmd += [flag, str(pre[key])]
        if pre.get("KEEP_ALL", False):
            cmd.append("--keep_all")
        _run(run_stage, "preprocess", cmd + ["--device", device])

    if c["TRAIN"].get("ISTRUE", True):
        _run(run_stage, "train", ["--cfg", cfg_path, "--device", device])

    test = c.get("TEST", {})
    if test.get("ISTRUE", True):
        data = test.get("DATA", "VOT2018")
        result_dir = test.get("RESULT_DIR", "var/result")
        cmd = ["--start_epoch", str(test.get("START_EPOCH", 10)),
               "--end_epoch", str(test.get("END_EPOCH", 30)),
               "--dataset", data,
               "--snapshot_dir", c.get("CHECKPOINT_DIR", "var/snapshot"),
               "--result_dir", result_dir,
               "--processes", str(test.get("PROCESSES", 1))]
        for key, flag in (("DATASET_ROOT", "--dataset_root"),
                          ("ENGINE", "--engine"),
                          ("MEM_SIZE", "--mem_size")):
            if key in test:
                cmd += [flag, str(test[key])]
        # the trained model's widths (the test CLI defaults to 64/256)
        for key, flag in (("WIDTH", "--width"), ("CHANNELS", "--channels")):
            if key in c["TRAIN"]:
                cmd += [flag, str(c["TRAIN"][key])]
        _run(run_stage, "test_epochs", cmd + ["--device", device])

        result_root = os.path.join(result_dir, data)
        trackers = sorted(os.listdir(result_root)) if \
            os.path.isdir(result_root) else []
        if trackers:
            # Tolerate eval failures (e.g. a stale/partial tracker dir
            # from an earlier killed run): the train + per-epoch test
            # results above are already complete and on disk, matching
            # the reference one-key behavior of not gating on eval.
            try:
                _run(run_stage, "evaluate", [
                    "--dataset_dir", test.get("DATASET_ROOT",
                                              args.dataset_dir),
                    "--dataset", data,
                    "--tracker_result_dir", result_root,
                    "--trackers", *trackers])
            except subprocess.CalledProcessError as e:
                print(f"onekey: evaluate stage failed (rc={e.returncode});"
                      " train/test results are intact", file=sys.stderr)
            except Exception:
                traceback.print_exc()
                print("onekey: evaluate stage failed; train/test results "
                      "are intact", file=sys.stderr)

    with open(os.path.join(log_dir, "onekey_stages.json"), "w") as f:
        json.dump(STAGE_TIMES, f, indent=1)


if __name__ == "__main__":
    main()
