"""The port's full-schedule tool (`usot_tpu_torch.tools.
train_full_schedule`) through its real subprocess path on the CPU, the
JSON config read without PyYAML, and `cli.make_shards.main(argv,
reader)` against shard sets from files.

The schedule is the reference's 30 epochs at the fixture's widths
(w8c32, B=2, 2 samples: one step per epoch), every transition crossed;
the kill lands in epoch 8 (the tool's `--kill`), so the resume from
`checkpoint_e7.pth` crosses the unfreezing at epoch 10, where the
resumed run rebuilds the optimizer as the unbroken run did.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from usot_tpu_torch.tools import train_full_schedule as tfs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
END, KILL = 30, 8
torch.set_num_threads(2)


def _args(root):
    return tfs.parse_args([
        "--kill", str(KILL), "--width", "8", "--channels", "32",
        "--samples", "2", "--batch", "2", "--videos", "2",
        "--device", "cpu", "--root", str(root)])


@pytest.fixture(scope="module")
def schedule(tmp_path_factory):
    """The tool's three children (2 torch threads each, as this
    process)."""
    root = tmp_path_factory.mktemp("full_schedule")
    args = _args(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        record = tfs.run(args)
    return SimpleNamespace(root=root, args=args, record=record)


def test_kill_and_resume_are_bitwise(schedule):
    """The interrupted prefix and the resumed epochs equal the unbroken
    run bit for bit (0.0, as JAX on the CPU); the interrupted child
    completed epochs 1..KILL-1 and the resume KILL..END; the checkpoints
    and the step times were logged."""
    rec = schedule.record
    assert rec["failures"] == []
    assert rec["interrupted_prefix_max_delta"] == 0.0
    assert rec["resume_max_loss_delta"] == 0.0
    assert rec["resume_exact"] is True
    losses = rec["losses"]
    assert sorted(map(int, losses["interrupted"])) == list(range(1, KILL))
    assert sorted(map(int, losses["resumed"])) == list(range(KILL, END + 1))
    for e in range(1, END + 1):
        assert len(losses["unbroken"][str(e)]) == 1
        assert all(np.isfinite(losses["unbroken"][str(e)]))
    steps = rec["unbroken_steps"]
    assert set(steps["ms_per_step"]) == {"naive", "cycle_frozen",
                                         "cycle_unfrozen"}
    assert steps["checkpoint"]["count"] == END - 4  # epochs 5..END
    assert steps["checkpoint"]["bytes"] > 0
    snap = schedule.root / "interrupted" / "snapshot"
    assert sorted(os.listdir(snap)) == sorted(
        f"checkpoint_e{e}.pth" for e in range(5, END + 1))
    # the killed child logged epochs 1..KILL-1 (it held in epoch KILL)
    with open(schedule.root / "timing_interrupted.jsonl") as f:
        logged = [json.loads(line)["epoch"] for line in f]
    assert logged == list(range(1, KILL))


def _jax_transitions(epochs, end_epoch):
    """The repo tool's own `transitions` dict, read from the source of
    `tools/train_full_schedule.py` and evaluated on `epochs`."""
    path = os.path.join(ROOT, "tools", "train_full_schedule.py")
    tree = ast.parse(open(path).read())
    node = next(n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "transitions")
    expr = ast.fix_missing_locations(ast.Expression(node))
    return eval(compile(expr, path, "eval"),
                {"epochs": epochs,
                 "args": SimpleNamespace(end_epoch=end_epoch)})


def test_transitions_equal_the_jax_tools_checks(schedule):
    rec = schedule.record
    with open(schedule.root / "unbroken" / "log" / "train_record.json") as f:
        epochs = json.load(f)["epochs"]
    want = _jax_transitions(epochs, END)
    assert rec["transitions"] == want
    assert all(v for v in want.values() if isinstance(v, bool))
    assert want["lambda_shifts"] == [0.3, 0.275, 0.25]
    assert want["cls_ratio_shifts"] == [0.6, 0.5, 0.4]


def test_children_losses_equal_an_in_process_run(schedule, tmp_path):
    """`cli.train.train(cfg, args)` in this process, on the same config
    and shards, gives the children's losses bit for bit."""
    from usot_tpu_torch.cli.train import parse_args, train
    from usot_tpu_torch.config.defaults import load_config

    cfg = load_config(str(schedule.root / "unbroken.json"))
    cfg.OUTPUT_DIR = str(tmp_path / "log")
    cfg.CHECKPOINT_DIR = str(tmp_path / "snapshot")
    args = parse_args(["--shards", str(schedule.root / "shards"),
                       "--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)
        record = train(cfg, args)
    assert {e: r["losses"] for e, r in record["epochs"].items()} == \
        schedule.record["losses"]["unbroken"]


def test_json_config_is_read_without_yaml(tmp_path):
    """The tool's JSON config: the port's `load_config` with `import
    yaml` made to fail (in a child process) gives what JAX's
    `update_config` gives on the same file with PyYAML."""
    from usot_tpu.config.defaults import load_config as jax_load

    args = _args(tmp_path)
    path = tfs.write_cfg(str(tmp_path), "cfg", "crop", "train.json", args,
                         END)
    script = textwrap.dedent(f"""
        import json, sys
        sys.modules["yaml"] = None  # `import yaml` raises ImportError
        from usot_tpu_torch.config.defaults import load_config
        print(json.dumps(load_config({path!r})))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    port = json.loads(out)
    assert port == json.loads(json.dumps(jax_load(path)))
    assert port["USOT"]["TRAIN"]["UNFIX_EPOCH"] == 10
    assert port["USOT"]["TRAIN"]["WIDTH"] == 8


def test_make_shards_with_a_reader_equals_shards_from_files(tmp_path):
    """`make_shards.main(argv, reader)` on frames in memory writes the
    shards `main(argv)` writes from the same frames as files (PNG, so
    the decoded pixels are the arrays), a naive epoch (5) and a
    cycle-memory one (6)."""
    import cv2

    from usot_tpu_torch.cli.make_shards import main as make_shards
    from usot_tpu_torch.tools.synthetic_crop511 import gen_dataset

    crop_dir, ann_path, reader = gen_dataset(str(tmp_path), 3)
    assert not os.path.exists(crop_dir)  # the frames are in memory only
    with open(ann_path) as f:
        ann = json.load(f)
    for vid, tracks in ann.items():
        for frame in tracks["00"]:
            if frame == "meta":
                continue
            path = os.path.join(crop_dir, vid, f"{int(frame):06d}.00.x.jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            ok, buf = cv2.imencode(".png", reader(path))
            with open(path, "wb") as f:
                f.write(buf.tobytes())
    cfg = tfs.write_cfg(str(tmp_path), "cfg", crop_dir, ann_path,
                        _args(tmp_path), END)
    common = ["--cfg", cfg, "--epochs", "5-6", "--samples", "4",
              "--workers", "2"]
    make_shards(common + ["--out", str(tmp_path / "files")])
    make_shards(common + ["--out", str(tmp_path / "memory")], reader)
    for epoch, cycle in ((5, False), (6, True)):
        sub = f"epoch_{epoch:03d}"
        a = tmp_path / "files" / sub
        b = tmp_path / "memory" / sub
        assert json.loads((a / "meta.json").read_text()) == \
            json.loads((b / "meta.json").read_text())
        assert json.loads((b / "meta.json").read_text())["cycle_memory"] \
            is cycle
        za, zb = np.load(a / "shard_00000.npz"), np.load(b / "shard_00000.npz")
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)

