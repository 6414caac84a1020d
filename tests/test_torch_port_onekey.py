"""The port's one-key pipeline (`usot_tpu_torch.cli.onekey`,
`cli.test_epochs`, `tools/onekey_synthetic.py`) against `usot_tpu`'s.

* the stage commands of one config, recorded from both packages (JAX's
  `_run` patched, the port's `run_stage`): the port's equal JAX's with
  `usot_tpu` -> `usot_tpu_torch` and `--device cpu` added to every stage
  that runs the network (the evaluation is host code); `test_epochs`'s
  test commands the same, sequential and with `--processes 2`;
* the port's chain through subprocesses on its synthetic data at w8c32
  with `--device cpu`: every stage leaves its artifacts, a result
  directory per epoch, a finite AUC.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from usot_tpu.cli import onekey as jax_onekey
from usot_tpu.cli import test_epochs as jax_test_epochs
from usot_tpu_torch.cli import onekey
from usot_tpu_torch.cli import test_epochs
from usot_tpu_torch.tools import onekey_synthetic

from torch_port_common import CHANNELS, WIDTH

DEVICE_STAGES = ("parse_flow", "train", "test_epochs")


def _ported(cmd):
    """JAX's command as the port runs it."""
    module = cmd[2].replace("usot_tpu.", "usot_tpu_torch.", 1)
    out = cmd[:2] + [module] + cmd[3:]
    if module.rsplit(".", 1)[1] in DEVICE_STAGES + ("test",):
        out += ["--device", "cpu"]
    return out


def _config(tmp_path, **kw):
    cfg = onekey_synthetic.build_config(str(tmp_path / "work"), samples=8,
                                        **kw)
    cfg["USOT"]["PREPROCESS"].update(MAX_FRAMES=30, LIMIT=2)
    cfg["USOT"]["TEST"]["PROCESSES"] = 2
    # a tracker directory for the evaluation stage to find
    os.makedirs(os.path.join(cfg["USOT"]["TEST"]["RESULT_DIR"], "OTB2015",
                             "USOTcheckpoint_e5"))
    path = str(tmp_path / "onekey.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


def _record_port(argv, cfg=None):
    cmds = []
    onekey.main(argv, cfg=cfg, run_stage=lambda stage, a: cmds.append(
        onekey.stage_command(stage, a)))
    return cmds


def test_stage_commands_equal_jax(tmp_path, monkeypatch):
    cfg, path = _config(tmp_path)
    theirs = []
    monkeypatch.setattr(jax_onekey, "_run",
                        lambda cmd, stage=None: theirs.append(list(cmd)))
    jax_onekey.main(["--cfg", path])
    ours = _record_port(["--cfg", path, "--device", "cpu"])
    assert [c[2].rsplit(".", 1)[1] for c in theirs] == \
        ["parse_flow", "train", "test_epochs", "evaluate"]
    assert ours == [_ported(c) for c in theirs]
    assert ours[-1][-2:] == ["--trackers", "USOTcheckpoint_e5"]
    # the config as a dict: the trainer's file is named under OUTPUT_DIR
    by_dict = _record_port(["--device", "cpu"], cfg=cfg)
    cfg_file = os.path.join(cfg["USOT"]["OUTPUT_DIR"], "onekey.yaml")
    assert by_dict[1] == onekey.stage_command(
        "train", ["--cfg", cfg_file, "--device", "cpu"])
    assert by_dict[:1] + by_dict[2:] == ours[:1] + ours[2:]
    assert json.load(open(os.path.join(cfg["USOT"]["OUTPUT_DIR"],
                                       "onekey_stages.json"))) == \
        {s: onekey.STAGE_TIMES[s] for s in
         ("preprocess", "train", "test_epochs", "evaluate")}


def test_test_stage_takes_the_trained_widths(tmp_path):
    """A port extension: TRAIN.WIDTH/CHANNELS, where the config gives
    them, reach the test runs (JAX's test CLI would build its default
    64/256 model)."""
    cfg, _ = _config(tmp_path, width=WIDTH, channels=CHANNELS)
    cmds = _record_port(["--device", "cpu"], cfg=cfg)
    test_cmd = cmds[2]
    assert test_cmd[-6:] == ["--width", str(WIDTH), "--channels",
                             str(CHANNELS), "--device", "cpu"]


def test_onekey_without_a_gpu_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg, _ = _config(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        _record_port([], cfg=cfg)


class _Proc:
    def __init__(self, cmd, log):
        log.append(("start", list(cmd)))
        self.cmd, self.log = cmd, log

    def wait(self):
        self.log.append(("wait", list(self.cmd)))
        return 0


@pytest.mark.parametrize("processes", [1, 2])
def test_test_epochs_commands_equal_jax(tmp_path, monkeypatch, processes):
    snap = tmp_path / "snap"
    snap.mkdir()
    for e in (5, 6, 8):
        (snap / f"checkpoint_e{e}.ckpt").write_bytes(b"")
    argv = ["--start_epoch", "4", "--end_epoch", "9", "--dataset", "OTB2015",
            "--snapshot_dir", str(snap), "--processes", str(processes),
            "--dataset_root", "bench", "--result_dir", "res", "--mem_size",
            "2", "--engine", "parity"]
    logs = {}
    for pkg, mod in (("jax", jax_test_epochs), ("port", test_epochs)):
        log = logs[pkg] = []
        monkeypatch.setattr(mod.subprocess, "run",
                            lambda cmd, check=False, log=log: (
                                log.append(("run", list(cmd))),
                                subprocess.CompletedProcess(cmd, 0))[1])
        monkeypatch.setattr(mod.subprocess, "Popen",
                            lambda cmd, log=log: _Proc(cmd, log))
        mod.main(argv + (["--device", "cpu"] if pkg == "port" else []))
        monkeypatch.undo()
    assert len(logs["jax"]) == (3 if processes == 1 else 6)
    assert logs["port"] == [(kind, _ported(cmd))
                            for kind, cmd in logs["jax"]]
    # the port's trainer writes `.pth`: preferred to a `.ckpt`
    (snap / "checkpoint_e6.pth").write_bytes(b"")
    args = test_epochs.parse_args(argv)
    resumes = [c[c.index("--resume") + 1] for c in test_epochs.commands(args)]
    assert [os.path.basename(r) for r in resumes] == [
        "checkpoint_e5.ckpt", "checkpoint_e6.pth", "checkpoint_e8.ckpt"]


def test_chain_through_subprocesses(tmp_path):
    """parse_flow -> train (a naive and a cycle-memory epoch) ->
    test_epochs (both checkpoints) -> evaluate, each a subprocess of the
    port's CLI on the CPU at w8c32."""
    work = tmp_path / "onekey"
    summary = onekey_synthetic.run(str(work), n_videos=1, n_frames=12,
                                   samples=4, device="cpu", width=WIDTH,
                                   channels=CHANNELS)
    prep = work / "prep"
    assert json.load(open(prep / "raw.json"))
    train_json = json.load(open(prep / "train.json"))
    assert list(train_json) == ["video00"]
    crops = os.listdir(prep / "crop511" / "video00")
    assert len(crops) == 12
    assert sorted(os.listdir(work / "snapshot")) == [
        "checkpoint_e5.pth", "checkpoint_e6.pth"]
    trackers = ["USOTcheckpoint_e5", "USOTcheckpoint_e6"]
    assert sorted(os.listdir(work / "result" / "OTB2015")) == trackers
    for t in trackers:
        assert sorted(os.listdir(work / "result" / "OTB2015" / t)) == [
            "Synth0.txt", "Synth1.txt"]
    assert summary["trackers"] == trackers
    assert all(np.isfinite(v) for v in summary["auc"].values())
    assert set(summary["stage_seconds"]) == {"preprocess", "train",
                                             "test_epochs", "evaluate"}


def test_evaluate_failure_is_tolerated(tmp_path, capsys):
    """As in JAX: a failing evaluation is reported, the run completes."""
    cfg, _ = _config(tmp_path)

    def run_stage(stage, argv):
        if stage == "evaluate":
            raise subprocess.CalledProcessError(3, ["evaluate"])

    onekey.main(["--device", "cpu"], cfg=cfg, run_stage=run_stage)
    assert "evaluate" not in onekey.STAGE_TIMES
    assert "rc=3" in capsys.readouterr().err
    assert set(onekey.STAGE_TIMES) == {"preprocess", "train", "test_epochs"}

    def failing_train(stage, argv):
        if stage == "train":
            raise subprocess.CalledProcessError(1, ["train"])

    # any other stage's failure ends the run
    with pytest.raises(subprocess.CalledProcessError):
        onekey.main(["--device", "cpu"], cfg=cfg, run_stage=failing_train)


def test_config_dict_needs_no_yaml(tmp_path, monkeypatch):
    """With the config as a dict and a `run_stage`, nothing imports
    PyYAML (the card's machine has none); the default subprocess runner
    writes the trainer's file with it."""
    cfg, _ = _config(tmp_path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    cmds = _record_port(["--device", "cpu"], cfg=cfg)
    assert len(cmds) == 4
    cfg_file = os.path.join(cfg["USOT"]["OUTPUT_DIR"], "onekey.yaml")
    assert not os.path.exists(cfg_file)
    monkeypatch.undo()
    monkeypatch.setattr(onekey, "run_subprocess", lambda stage, argv: None)
    onekey.main(["--device", "cpu"], cfg=cfg)
    assert yaml.safe_load(open(cfg_file)) == cfg
