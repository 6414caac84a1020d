"""The port's benchmark-scale VOT protocol tool
(`usot_tpu_torch.tools.vot_protocol_bench`) against the repo's
`tools/vot_protocol_bench.py` and the JAX CLI, on the CPU.

* The generator: for 3 videos of 24-48 frames at 120x160 the port's
  rendered frames equal, bitwise, the arrays the repo tool hands to
  `cv2.imwrite` (captured by replacing `cv2.imwrite` inside the test),
  and its ground-truth files, `list.txt` order and `meta` equal the
  repo tool's.
* `compare_results` gives the repo tool's summary on the same result
  dicts, one pair identical and one divergent.
* The tool end to end at the fixture's widths (3 videos, 2 lanes, chunk
  8, both engines) against the JAX CLI's `track_dataset_vot_batched` and
  `track_video_scan` on the same frames (`cv2.imread` answered by the
  port's reader) and weights: every video's restart skeleton is
  identical and its boxes agree within 0.5 px
  (`tests/test_torch_port_cli.py`). Both packages' init crops use the
  port's `get_subwindow` (`test_torch_port_engine.py`).
"""
import copy
import os

import cv2
import numpy as np
import pytest
import torch

import usot_tpu.cli.test as jax_cli
import usot_tpu.tracker.engine as jax_engine
from tools import vot_protocol_bench as jax_tool
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.tools import vot_protocol_bench as tool

from torch_port_common import CHANNELS, WIDTH, load_fixture

torch.set_num_threads(2)
GEN = dict(n_videos=3, min_frames=24, max_frames=48, h=120, w=160)


def test_frames_and_ground_truth_equal_the_repo_tool(tmp_path, monkeypatch):
    written = {}

    def imwrite(path, im, params=None):
        written[os.path.relpath(path, tmp_path)] = im.copy()
        return True

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    want_meta = jax_tool.gen_benchmark(str(tmp_path), **GEN)
    videos, meta = tool.gen_benchmark(**GEN)
    assert meta == want_meta
    dataset, reader = tool.dataset_and_reader(videos, str(tmp_path))
    assert len(written) == meta["total_frames"] == sum(v["n"] for v in videos)
    for rel, im in written.items():
        got = reader(os.path.join(tmp_path, rel))
        assert got.dtype == im.dtype == np.uint8
        np.testing.assert_array_equal(got, im, err_msg=rel)
    base = tmp_path / "VOT2018"
    assert list(dataset) == sorted(
        (base / "list.txt").read_text().split())
    for v in videos:
        text = (base / v["name"] / "groundtruth.txt").read_text()
        assert tool.groundtruth_text(v) == text
        np.testing.assert_array_equal(
            dataset[v["name"]]["gt"],
            np.loadtxt(base / v["name"] / "groundtruth.txt", delimiter=","))
        assert [os.path.relpath(p, tmp_path) for p in
                dataset[v["name"]]["image_files"]] == sorted(
            k for k in written if k.startswith(f"VOT2018/{v['name']}/"))
    assert reader(os.path.join(tmp_path, "VOT2018", "spill", "x.jpg")) is None


def test_compare_results_equals_the_repo_tool():
    rng = np.random.default_rng(3)

    def rows(n, skel):
        return [s if isinstance(s, int) else rng.uniform(0, 100, 8).tolist()
                for s in skel[:n]]

    a = {"spill": rows(9, [1, "b", "b", 2, 0, 0, 0, 0, 1]),
         "vid001": rows(6, [1] + ["b"] * 5)}
    same = copy.deepcopy(a)
    for name in same:
        same[name] = [r if isinstance(r, int) else
                      (np.asarray(r) + rng.normal(0, 0.01, 8)).tolist()
                      for r in same[name]]
    diverged = copy.deepcopy(same)
    diverged["spill"][3:] = [[1.0] * 8, 2, 0, 0, 0, 0]
    for b in (same, diverged):
        assert tool.compare_results(a, b) == jax_tool.compare_results(a, b)
    assert tool.compare_results(a, diverged)["skeleton_divergences"] == [
        {"video": "spill", "first_mismatch_frame": 3, "frames": 9,
         "identical_restarts_before": 0}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port tool's record, the JAX CLI's result rows per engine, and
    the TF32 switches as the tool left them, both set on before it ran
    (cuDNN's own default)."""
    tmp = tmp_path_factory.mktemp("votbench")
    kw, v = load_fixture()
    pth = tmp / "fixture.pth"
    torch.save(state_dict_from_flax(v), pth)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ours = tool.main([
        "--device", "cpu", "--videos", "3", "--min-frames", "24",
        "--max-frames", "48", "--h", "120", "--w", "160", "--chunk", "8",
        "--batch", "2", "--width", str(WIDTH), "--channels", str(CHANNELS),
        "--ckpt", str(pth), "--root", str(tmp / "port"),
        "--out", str(tmp / "votbench.json")])
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}

    videos, _ = tool.gen_benchmark(**GEN)
    dataset, reader = tool.dataset_and_reader(videos, str(tmp / "jax"))
    jm = jax_build(**kw)
    jr = JaxRunner(jm, v)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        mp.setattr(cv2, "imread", lambda path, *a: reader(path))
        for engine in ("batch", "scan"):
            rdir = tmp / f"jax_{engine}"
            jargs = jax_cli.parse_args([
                "--dataset", "VOT2018", "--engine", engine, "--chunk", "8",
                "--batch", "2", "--result_dir", str(rdir)])
            if engine == "batch":
                jax_cli.track_dataset_vot_batched(jm, v, jr, dataset, jargs)
            else:
                engines = {}
                for name in dataset:
                    jax_cli.track_video_scan(jm, v, jr, dataset[name], jargs,
                                             engines)
            want[engine] = jax_tool.read_results(str(rdir))
    return ours, want, tf32


@pytest.mark.parametrize("engine", ["batch", "scan"])
def test_tool_matches_the_jax_cli(runs, engine):
    ours, want, _ = runs
    got = ours["results"][engine]
    assert sorted(got) == sorted(want[engine]) == ["spill", "vid001",
                                                   "vid002"]
    for name in got:
        assert tool.skeleton(got[name]) == tool.skeleton(want[engine][name])
        for i, (a, b) in enumerate(zip(got[name], want[engine][name])):
            if not isinstance(a, int):
                np.testing.assert_allclose(a, b, atol=0.5, rtol=0,
                                           err_msg=f"{name} row {i}")
    rec = ours[engine]
    assert rec["total_frames"] == ours["benchmark"]["total_frames"]
    assert rec["restarts"] == sum(r == 2 for rows in got.values()
                                  for r in rows)
    assert rec["track_s"] <= rec["wall_s"] and rec["k1_launches"] == 0


def test_tool_record(runs):
    ours, *_ = runs
    assert ours["compare"]["videos"] == 3
    # the spill video's re-init flips the search size in the batch run
    assert ours["batch"]["spilled"] == ["spill"]
    assert ours["scan"]["spilled"] == []
    assert ours["batch"]["restarts"] == ours["scan"]["restarts"] >= 1
    assert "card" not in ours and ours["device"] == "cpu"


def test_tool_keeps_f32_numerics(runs):
    """The tool calls the CLI's tracking functions, not its `main`, so it
    turns TF32 off itself: on the card its f32 convolutions would else
    run in TF32."""
    *_, tf32 = runs
    assert tf32 == {"cudnn": False, "matmul": False}
