"""The port's test CLI (`usot_tpu_torch.cli.test`) and the host helpers it
copies (geometry, polygon IoU, VOT region overlap, benchmark loader,
frame decoding), against `usot_tpu` on the CPU.

The port runs as a user runs it, `main(argv)` with `--device cpu`, the
fixture's widths (`--width 8 --channels 32`) and `--resume` a `.pth`
written from the trained fixture. The reference is the JAX CLI's own
functions on the same weights and the same PNG (OTB) and JPEG (VOT, GOT)
files: `track_video` for the parity tracker, `track_video_scan` for every
engine path (the JAX scan engine computed once per dataset). Both
packages' init crops use the port's `get_subwindow` (see
`test_torch_port_engine.py`). Held: the same result files with the same
line counts, identical VOT restart skeletons (1/2/0 rows, the failures
forced by the ground truth), bbox columns within 0.5 px, and
`usot_tpu.cli.evaluate` scoring the port's result directories.
The tiny fixture's response maps on these noise frames are flat (scores
~0.49); on some seeds two cells tie within the packages' f32 gap and the
tracks part by pixels from the second frame on (seed 20 of `_frames`
does: 4.3 px). The seeds here are ones without such a tie.
"""
import json
import os
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import usot_tpu.cli.test as jax_cli
import usot_tpu.tracker.engine as jax_engine
import usot_tpu.tracker.tracker as jax_tracker
from usot_tpu.core import geometry as jax_geometry
from usot_tpu.data.benchmark import load_dataset as jax_load_dataset
from usot_tpu.eval.polygon import poly_iou as jax_poly_iou
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu.tracker.tracker import USOTTracker as JaxTracker
from usot_tpu_torch.cli import test as cli
from usot_tpu_torch.core import geometry
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.data import imageio
from usot_tpu_torch.data.benchmark import load_dataset
from usot_tpu_torch.eval import region
from usot_tpu_torch.eval.polygon import poly_iou
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.tracker.config import TrackerConfig

from torch_port_common import load_fixture

torch.set_num_threads(2)
SIZE, BOX = 320, 48


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    frames, centers = [], []
    for f in range(n):
        im = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
        cx, cy = 100 + 5 * f, 120 + 3 * f
        im[cy - 24:cy + 24, cx - 24:cx + 24] = [200, 180, 60]
        frames.append(im)
        centers.append((cx, cy))
    return frames, centers


def _quad(cx, cy, half):
    return [cx - half, cy - half, cx + half, cy - half,
            cx + half, cy + half, cx - half, cy + half]


def _write_datasets(root):
    """OTB2015 (PNG, 2 videos), VOT2018 (JPEG, 3 videos, polygons, forced
    failures, one restart with a 16-px box: a spill for --engine batch)
    and GOT10K (JPEG, test layout: the first box only)."""
    meta = {}
    for i, (vid, n) in enumerate((("Car1", 6), ("Walk2", 9))):
        frames, centers = _frames(n, seed=i)
        d = root / "OTB2015" / vid / "img"
        d.mkdir(parents=True)
        names = []
        for f, im in enumerate(frames):
            names.append(f"{f + 1:04d}.png")
            cv2.imwrite(str(d / names[-1]), im)
        gt = [[centers[0][0] - 23, centers[0][1] - 23, BOX, BOX]] * n
        meta[vid] = {"video_dir": vid, "init_rect": gt[0],
                     "img_names": [f"{vid}/img/{x}" for x in names],
                     "gt_rect": gt, "attr": []}
    (root / "OTB2015.json").write_text(json.dumps(meta))

    vot = root / "VOT2018"
    vot_meta = {}
    for i, (vid, fail, spill) in enumerate((("ball", 3, False),
                                            ("bolt", None, False),
                                            ("crab", 2, True))):
        n = 14
        frames, centers = _frames(n, seed=10 + i)
        d = vot / vid / "color"
        d.mkdir(parents=True)
        gts, names = [], []
        for f, im in enumerate(frames):
            names.append(f"{f + 1:08d}.jpg")
            cv2.imwrite(str(d / names[-1]), im)
            if f == 0 or (fail is not None and f == fail + 5):
                half = 8 if spill and f else 24
                gts.append(_quad(*centers[f], half))
            elif f == fail:
                gts.append(_quad(SIZE + 60, SIZE + 60, 10))
            else:
                gts.append([0, 0, SIZE, 0, SIZE, SIZE, 0, SIZE])
        (d / "groundtruth.txt").write_text(
            "\n".join(",".join(str(float(v)) for v in g) for g in gts))
        vot_meta[vid] = {
            "video_dir": vid, "init_rect": [76, 96, 48, 48],
            "img_names": [f"{vid}/color/{x}" for x in names],
            "gt_rect": gts, **{tag: [0] * n for tag in (
                "camera_motion", "illum_change", "motion_change",
                "size_change", "occlusion")}}
    (vot / "list.txt").write_text("ball\nbolt\ncrab\n")
    (root / "VOT2018.json").write_text(json.dumps(vot_meta))

    got = root / "GOT10K"
    frames, centers = _frames(7, seed=21)
    d = got / "GOT-10k_Test_000001"
    d.mkdir(parents=True)
    for f, im in enumerate(frames):
        cv2.imwrite(str(d / f"{f + 1:08d}.jpg"), im)
    (d / "groundtruth.txt").write_text(
        f"{centers[0][0] - 24},{centers[0][1] - 24},{BOX},{BOX}\n")
    (got / "list.txt").write_text("GOT-10k_Test_000001\n")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Datasets, the fixture as a .pth, the JAX CLI's results (parity on
    OTB and GOT, the scan engine on all three) and a cache of the port's
    runs."""
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "datasets"
    _write_datasets(root)
    kw, v = load_fixture()
    pth = tmp / "fixture.pth"
    torch.save(state_dict_from_flax(v), pth)

    jm = jax_build(**kw)
    jr = JaxRunner(jm, v)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "get_subwindow", get_subwindow)
    mp.setattr(jax_tracker, "get_subwindow", get_subwindow)
    engines = {}
    for ds, engine in (("OTB2015", "parity"), ("GOT10K", "parity"),
                       ("OTB2015", "scan"), ("VOT2018", "scan"),
                       ("GOT10K", "scan")):
        args = jax_cli.parse_args([
            "--dataset", ds, "--engine", engine, "--chunk", "4",
            "--result_dir", str(tmp / f"jax_{engine}")])
        dataset = jax_load_dataset(ds, str(root))
        for name in dataset:
            if engine == "parity":
                jax_cli.track_video(JaxTracker(), jr, dataset[name], args)
            else:
                jax_cli.track_video_scan(jm, v, jr, dataset[name], args,
                                         engines)
    mp.undo()
    yield SimpleNamespace(tmp=tmp, root=root, pth=pth, kw=kw, port={})


def _port(env, dataset, tag, *extra):
    """The port CLI's result directory of one run (run once per module)."""
    key = (dataset, tag)
    if key not in env.port:
        out = env.tmp / f"port_{tag}"
        cli.main(["--dataset", dataset, "--dataset_root", str(env.root),
                  "--result_dir", str(out), "--resume", str(env.pth),
                  "--device", "cpu", "--width", "8", "--channels", "32",
                  "--mem_size", str(env.kw["mem_size"]), "--chunk", "4",
                  "--batch", "3", *extra])
        env.port[key] = out
    return env.port[key] / dataset / "USOT"


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def _rows(path):
    return [ln.split(",") for ln in path.read_text().splitlines()]


def _compare(ours_dir, want_dir):
    """Same files and line counts; per row the same kind (a flag or a
    box) and, for boxes, every column within 0.5 px. Times (GOT) are
    compared by count only."""
    assert _files(ours_dir) == _files(want_dir)
    for rel in _files(want_dir):
        ours, want = _rows(ours_dir / rel), _rows(want_dir / rel)
        assert len(ours) == len(want), rel
        if rel.endswith("_time.txt"):
            continue
        for i, (a, b) in enumerate(zip(ours, want)):
            assert len(a) == len(b), (rel, i)
            if len(a) == 1:
                assert a == b, (rel, i)
            else:
                np.testing.assert_allclose(np.float64(a), np.float64(b),
                                           atol=0.5, rtol=0,
                                           err_msg=f"{rel} row {i}")


OTB_RUNS = {
    "parity": ("parity", ["--engine", "parity"]),
    "scan": ("scan", ["--engine", "scan"]),
    "batch-refill": ("scan", ["--engine", "batch", "--refill", "1"]),
    "batch-padded": ("scan", ["--engine", "batch", "--refill", "0"]),
    "batch-roi": ("scan", ["--engine", "batch", "--roi", "288"]),
    "batch-roi-auto": ("scan", ["--engine", "batch", "--roi", "auto",
                                "--roi-chunk", "3"]),
}


@pytest.mark.parametrize("tag", list(OTB_RUNS))
def test_otb_results_match_jax(env, tag):
    ref, extra = OTB_RUNS[tag]
    _compare(_port(env, "OTB2015", tag, *extra),
             env.tmp / f"jax_{ref}" / "OTB2015" / "USOT")


@pytest.mark.parametrize("engine", ["scan", "batch"])
def test_vot_results_match_jax(env, engine, capsys):
    """The restart skeleton: ball fails at 3 (re-init at 8), bolt never,
    crab fails at 2 and re-inits at 7 on a 16-px box, which the batch
    engine spills to the scan engine."""
    ours = _port(env, "VOT2018", f"vot-{engine}", "--engine", engine)
    if engine == "batch":
        assert "spill: crab re-init at frame 7" in capsys.readouterr().out
    _compare(ours, env.tmp / "jax_scan" / "VOT2018" / "USOT")
    kinds = [r[0] if len(r) == 1 else "bbox" for r in
             _rows(ours / "baseline" / "ball" / "ball_001.txt")]
    assert kinds == ["1", "bbox", "bbox", "2", "0", "0", "0", "0", "1"] \
        + ["bbox"] * 5


@pytest.mark.parametrize("engine", ["parity", "scan"])
def test_got_layout_matches_jax(env, engine):
    ours = _port(env, "GOT10K", f"got-{engine}", "--engine", engine)
    assert _files(ours) == ["GOT-10k_Test_000001/GOT-10k_Test_000001_001"
                            ".txt", "GOT-10k_Test_000001/GOT-10k_Test_"
                            "000001_time.txt"]
    _compare(ours, env.tmp / f"jax_{engine}" / "GOT10K" / "USOT")


def test_evaluate_scores_the_port_results(env):
    """`usot_tpu.cli.evaluate` scores the port's result files, and the
    port's own `evaluate` gives the same numbers."""
    from usot_tpu.cli.evaluate import evaluate
    from usot_tpu_torch.cli.evaluate import evaluate as port_evaluate

    def equal(ours, theirs):
        if isinstance(theirs, dict):
            assert list(ours) == list(theirs)
            for k in theirs:
                equal(ours[k], theirs[k])
        else:  # arrays and lists of numbers, NaN where NaN
            np.testing.assert_array_equal(ours, theirs)

    def both(name, result_dir):
        out = evaluate(name, str(env.root), result_dir, ["USOT"])
        equal(port_evaluate(name, str(env.root), result_dir, ["USOT"]), out)
        return out

    otb = _port(env, "OTB2015", "scan", "--engine", "scan")
    out = both("OTB2015", str(otb.parent))
    for success in out["success"]["USOT"].values():
        assert success.shape == (21,) and success[0] > 0
    vot = _port(env, "VOT2018", "vot-batch", "--engine", "batch")
    out = both("VOT2018", str(vot.parent))
    assert out["ar"]["USOT"]["failures"] == {"ball": [1], "bolt": [0],
                                             "crab": [1]}


def test_existing_results_are_kept(env):
    """A video whose result file exists is skipped, as in the JAX CLI."""
    out = _port(env, "OTB2015", "scan", "--engine", "scan")
    path = out / "Car1.txt"
    path.write_text("kept\n")
    try:
        cli.main(["--dataset", "OTB2015", "--dataset_root", str(env.root),
                  "--result_dir", str(out.parent.parent), "--resume",
                  str(env.pth), "--device", "cpu", "--width", "8",
                  "--channels", "32", "--engine", "scan"])
        assert path.read_text() == "kept\n"
    finally:
        path.unlink()
        env.port.pop(("OTB2015", "scan"))


@pytest.mark.parametrize("tag", ["parity", "batch-refill", "batch-roi"])
def test_bf16_engines_write_the_f32_layout(env, tmp_path, tag):
    """`--dtype bfloat16` on the parity tracker and on the batch engine
    with lane refill and with ROI streaming: the float32 run's files,
    line for line, every box finite."""
    f32 = _port(env, "OTB2015", tag, *OTB_RUNS[tag][1])
    cli.main(["--dataset", "OTB2015", "--dataset_root", str(env.root),
              "--result_dir", str(tmp_path), "--resume", str(env.pth),
              "--device", "cpu", "--width", "8", "--channels", "32",
              "--mem_size", str(env.kw["mem_size"]), "--chunk", "4",
              "--batch", "3", "--dtype", "bfloat16", *OTB_RUNS[tag][1]])
    ours = tmp_path / "OTB2015" / "USOT"
    assert _files(ours) == _files(f32)
    for rel in _files(f32):
        rows = np.float64(_rows(ours / rel))
        assert rows.shape == np.float64(_rows(f32 / rel)).shape, rel
        assert np.all(np.isfinite(rows)), rel


def test_cli_refuses_what_the_port_does_not_run(env, tmp_path):
    """`--dtype bfloat16` and a flax `--resume` (`.msgpack`), refused
    before the port had them, now run: the bf16 scan engine writes the
    float32 run's files, line for line, with finite boxes; the fixture
    read from its `.msgpack` writes the `.pth` run's files byte for byte.
    The GOT-10k layout on the batch engine is still refused."""
    from torch_port_common import FIXTURE

    base = ["--dataset", "OTB2015", "--dataset_root", str(env.root),
            "--device", "cpu", "--width", "8", "--channels", "32",
            "--mem_size", str(env.kw["mem_size"]), "--chunk", "4",
            "--batch", "3", "--engine", "scan"]
    f32 = _port(env, "OTB2015", "scan", "--engine", "scan")
    runs = {}
    for tag, extra in (("bf16", ["--resume", str(env.pth), "--dtype",
                                 "bfloat16"]),
                       ("msgpack", ["--resume", FIXTURE])):
        cli.main(base + ["--result_dir", str(tmp_path / tag)] + extra)
        runs[tag] = tmp_path / tag / "OTB2015" / "USOT"
        assert _files(runs[tag]) == _files(f32) == ["Car1.txt", "Walk2.txt"]
    for rel in _files(f32):
        want = (f32 / rel).read_text()
        assert (runs["msgpack"] / rel).read_text() == want, rel
        rows = np.float64(_rows(runs["bf16"] / rel))
        assert rows.shape == np.float64(_rows(f32 / rel)).shape, rel
        assert np.all(np.isfinite(rows)), rel
    with pytest.raises(SystemExit, match="GOT-10k"):
        cli.main(["--dataset", "GOT10K", "--dataset_root", str(env.root),
                  "--result_dir", str(tmp_path), "--device", "cpu",
                  "--engine", "batch", "--resume", str(env.pth),
                  "--width", "8", "--channels", "32"])
    assert cli.parse_args([]).device is None


# --------------------------------------------------- the copied helpers

def test_geometry_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        quad = rng.uniform(-50, 400, 8)
        rect = rng.uniform(1, 300, 4)
        assert geometry.get_axis_aligned_bbox(quad) == \
            jax_geometry.get_axis_aligned_bbox(quad)
        assert geometry.get_axis_aligned_bbox(rect) == \
            jax_geometry.get_axis_aligned_bbox(rect)
        np.testing.assert_array_equal(
            geometry.cxy_wh_2_rect(rect[:2], rect[2:]),
            jax_geometry.cxy_wh_2_rect(rect[:2], rect[2:]))
        for a, b in zip(geometry.rect_2_cxy_wh(rect),
                        jax_geometry.rect_2_cxy_wh(rect)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", [76.0, 76.8, 77.6, 300.0])
def test_instance_choice_equals_jax(monkeypatch, w):
    """`TrackerConfig.instance_of`, which the port's tracker, CLI and VOT
    protocol share, against the JAX CLI's choice for a (w, 16) target in
    a 480x640 image: below, at and above the 0.4 % area share, and far
    above it."""
    picked = []
    monkeypatch.setattr(jax_engine, "ScanEngine",
                        lambda model, v, p, **kw: picked.append(
                            p.instance_size))
    jax_cli._get_scan_engine({}, None, None, SimpleNamespace(chunk=4), 512,
                             640, 480, 640, (w, 16.0))
    assert TrackerConfig().instance_of((w, 16.0), 480, 640) == picked[0]


def test_poly_iou_equals_jax():
    """Convex and non-convex quads (the latter through `vot_overlap`),
    rects, disjoint and clipped to a bound."""
    rng = np.random.default_rng(1)
    cases = [([10, 10, 50, 12, 40, 60, 30, 35], [20, 20, 30, 30]),
             ([0, 0, 10, 0, 10, 10, 0, 10], [20, 20, 5, 5]),
             ([0, 0, 40, 0, 40, 40, 0, 40], [10, 10, 60, 60])]
    for _ in range(30):
        cases.append((rng.uniform(0, 100, 8), rng.uniform(5, 60, 4)))
    for a, b in cases:
        assert poly_iou(a, b) == jax_poly_iou(a, b)
        assert poly_iou(a, b, bound=(50, 45)) == \
            jax_poly_iou(a, b, bound=(50, 45))


def test_vot_overlap_native_equals_numpy_mirror():
    rng = np.random.default_rng(2)
    assert region._build_and_load() is not None
    for _ in range(20):
        a, b = rng.uniform(0, 80, 8), rng.uniform(0, 80, 8)
        for bounds in (None, (60, 50)):
            ours = region.vot_overlap(a, b, bounds)
            mirror = region._overlap_np(region._to_polygon(a),
                                        region._to_polygon(b),
                                        region._bounds_tuple(bounds))
            assert abs(ours - mirror) <= 1e-6
    assert np.isnan(region.vot_overlap([1.0], [0, 0, 2, 2]))


@pytest.mark.parametrize("name", ["OTB2015", "VOT2018", "GOT10K"])
def test_load_dataset_equals_jax(env, name):
    ours = load_dataset(name, str(env.root))
    want = jax_load_dataset(name, str(env.root))
    assert list(ours) == list(want)
    for video in want:
        assert ours[video]["image_files"] == want[video]["image_files"]
        assert ours[video]["name"] == want[video]["name"]
        np.testing.assert_array_equal(np.asarray(ours[video]["gt"]),
                                      np.asarray(want[video]["gt"]))


def test_read_image_cv2_pillow_and_arrays(env, monkeypatch, tmp_path):
    png = sorted((env.root / "OTB2015" / "Car1" / "img").iterdir())[0]
    want = cv2.imread(str(png))
    np.testing.assert_array_equal(imageio.read_image(png), want)
    gray = tmp_path / "gray.png"
    cv2.imwrite(str(gray), want[..., 0])
    np.testing.assert_array_equal(
        imageio.read_image(gray),
        cv2.cvtColor(want[..., 0], cv2.COLOR_GRAY2BGR))
    assert imageio.read_image(want) is want
    np.testing.assert_array_equal(imageio.read_image(want[..., 1]),
                                  np.repeat(want[..., 1:2], 3, axis=2))
    assert imageio.read_image(tmp_path / "missing.png") is None
    monkeypatch.setitem(sys.modules, "cv2", None)      # no OpenCV
    np.testing.assert_array_equal(imageio.read_image(png), want)
    np.testing.assert_array_equal(
        imageio.read_image(gray),
        cv2.cvtColor(want[..., 0], cv2.COLOR_GRAY2BGR))
    assert imageio.read_image(tmp_path / "missing.png") is None
    monkeypatch.setitem(sys.modules, "PIL", None)      # neither
    with pytest.raises(RuntimeError, match="cv2.*PIL"):
        imageio.read_image(png)
    assert imageio.read_image(want) is want
