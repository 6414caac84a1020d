"""The port's evaluation toolkit (`usot_tpu_torch.eval`, `cli.evaluate`)
against `usot_tpu`'s, on result directories this file writes.

* `evaluate` on every dataset family (OTB, UAV, NFS, LaSOT with its
  absent frames and norm precision, GOT-10k, TrackingNet, VOT with the
  restart protocol: accuracy-robustness, failures, EAO over 'all' and
  per tag; VOT-LT: F1), two trackers: every number EQUAL to JAX's (the
  same numpy arithmetic in the same order), `--num 2` equal to
  sequential;
* the statistics function by function, as `tests/test_eval.py` holds
  JAX's;
* `_image_size` read from the header against PIL's size, PNG and JPEG
  (baseline and progressive, gray and colour, with an EXIF segment);
* `--vis` writes its figures where matplotlib imports and raises a
  clear error where it does not.
"""
import json
import os
import sys

import numpy as np
import pytest

from usot_tpu.cli import evaluate as jax_evaluate
from usot_tpu.eval import statistics as jst
from usot_tpu_torch.cli import evaluate as port_evaluate
from usot_tpu_torch.eval import datasets as port_datasets
from usot_tpu_torch.eval import region as port_region
from usot_tpu_torch.eval import statistics as pst

TRACKERS = ["trkA", "trkB"]
VOT_TAGS = ("camera_motion", "illum_change", "motion_change", "size_change",
            "occlusion")
# name -> (dataset layout, first-frame format)
FAMILIES = {"OTB2015": ("ope", ".png"), "UAV123": ("ope", ".jpg"),
            "NFS30": ("ope", ".png"), "LaSOT": ("lasot", ".jpg"),
            "GOT10KVAL": ("got", ".jpg"), "TrackingNet": ("got", ".png"),
            "VOT2018": ("vot", ".jpg"), "VOT2018-LT": ("votlt", ".png")}


def _write_frame(path, h, w, seed):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    assert cv2.imwrite(path, (rng.random((h, w, 3)) * 255).astype(np.uint8))


def _row(v):
    return ",".join(repr(float(x)) for x in v)


def _gt_path(rng, n, h, w):
    """A box drifting over the frame, (n, 4) x, y, w, h."""
    size = rng.uniform(20, 60, 2)
    start = rng.uniform([0, 0], [w - size[0], h - size[1]])
    step = rng.uniform(-2, 2, 2)
    xy = np.clip(start + np.arange(n)[:, None] * step, 0,
                 [w - size[0], h - size[1]])
    return np.concatenate([xy, np.tile(size, (n, 1))], axis=1)


def _vot_run(rng, gt, fail_p):
    """A VOT restart-protocol trajectory: 1 at each init, boxes, 2 at a
    failure and 0 for the four frames after it."""
    rows, f = [], 0
    while f < len(gt):
        rows.append([1])
        f += 1
        while f < len(gt):
            if rng.random() < fail_p:
                rows.append([2])
                rows += [[0]] * min(4, len(gt) - f - 1)
                f += 5
                break
            rows.append(list(gt[f] + rng.normal(0, 3, 4)))
            f += 1
    return rows[:len(gt)]


def _polygon(r):
    x, y, w, h = r
    return [x, y, x + w, y, x + w, y + h, x, y + h]


def _build(root, name, layout, ext, seed):
    """The dataset JSON, each video's first frame, and both trackers'
    results under `root/results/<name>`."""
    rng = np.random.default_rng(seed)
    meta = {}
    results = os.path.join(root, "results", name)
    n_videos = 3
    for v in range(n_videos):
        vid = f"{name.lower()}-{v}"
        n = int(rng.integers(110, 150)) if layout in ("vot", "votlt") \
            else int(rng.integers(20, 40))
        h, w = int(rng.integers(200, 320)), int(rng.integers(240, 400))
        gt = _gt_path(rng, n, h, w)
        img_names = [f"{vid}/img/{i:04d}{ext}" for i in range(n)]
        base = root if layout == "got" else os.path.join(root, name)
        _write_frame(os.path.join(base, img_names[0]), h, w, seed + v)
        entry = {"video_dir": vid, "init_rect": gt[0].tolist(),
                 "img_names": img_names, "attr": ["A", "B"][: v % 3]}
        gt_rows = gt.tolist()
        if layout == "vot":
            gt_rows = [_polygon(r) if v % 2 else list(r) for r in gt]
            for t, tag in enumerate(VOT_TAGS):
                entry[tag] = [int(x) for x in rng.random(n) < 0.2 + 0.1 * t]
        if layout == "lasot":
            entry["absent"] = [int(x) for x in rng.random(n) > 0.1]
        if layout == "votlt":
            absent = rng.random(n) < 0.15
            absent[0] = False
            gt_rows = [[float("nan")] * 4 if a else r
                       for a, r in zip(absent, gt_rows)]
        entry["gt_rect"] = gt_rows
        meta[vid] = entry
        for t, trk in enumerate(TRACKERS):
            noise = 2.0 + 6.0 * t
            if layout == "vot":
                d = os.path.join(results, trk, "baseline", vid)
                os.makedirs(d, exist_ok=True)
                rows = _vot_run(rng, gt, 0.02 + 0.03 * t)
                with open(os.path.join(d, f"{vid}_001.txt"), "w") as f:
                    f.write("".join(_row(r) + "\n" for r in rows))
            elif layout == "votlt":
                d = os.path.join(results, trk, "longterm", vid)
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, f"{vid}_001.txt"), "w") as f:
                    f.write("1\n" + "".join(
                        _row(g + rng.normal(0, noise, 4)) + "\n"
                        for g in gt[1:]))
                with open(os.path.join(d, f"{vid}_001_confidence.value"),
                          "w") as f:
                    f.write("\n" + "".join(f"{float(c)!r}\n" for c in
                                           rng.random(n - 1)))
            else:
                d = os.path.join(results, trk)
                os.makedirs(d, exist_ok=True)
                pred = gt + rng.normal(0, noise, gt.shape)
                with open(os.path.join(d, f"{vid}.txt"), "w") as f:
                    f.write("".join(_row(r) + "\n" for r in pred))
    with open(os.path.join(root, f"{name}.json"), "w") as f:
        json.dump(meta, f)
    return results


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    for i, (name, (layout, ext)) in enumerate(FAMILIES.items()):
        _build(root, name, layout, ext, seed=10 * i)
    return root


def _equal(ours, theirs, where="result"):
    """Equal nested results: the same keys, the same values (NaN where
    NaN), numpy or not."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), where
        for k in theirs:
            _equal(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(theirs, (list, tuple)) and theirs and \
            isinstance(theirs[0], (dict, list, tuple, np.ndarray)):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _equal(a, b, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs),
                                      err_msg=where)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_evaluate_equals_jax(root, name, tmp_path, capsys):
    """`evaluate` on one dataset family, both trackers: the port's
    numbers are JAX's; `--num 2` gives the sequential numbers. VOT also
    with per-tag EAO (the radar's input, `vis`)."""
    results = os.path.join(root, "results", name)
    vis = name == "VOT2018"
    kw = dict(vis=vis, plot_dir=str(tmp_path / "plots"))
    theirs = jax_evaluate.evaluate(name, root, results, TRACKERS, **kw)
    jax_out = capsys.readouterr().out
    ours = port_evaluate.evaluate(name, root, results, TRACKERS, **kw)
    assert capsys.readouterr().out == jax_out  # the same tables
    _equal(ours, theirs)
    _equal(port_evaluate.evaluate(name, root, results, TRACKERS, num=2),
           port_evaluate.evaluate(name, root, results, TRACKERS, num=1))
    if name == "VOT2018":
        eao = ours["eao"]["trkA"]
        assert set(eao) == {"all", *VOT_TAGS, "empty"}
        assert np.isfinite(eao["all"])
        assert sum(np.isfinite(eao[t]) for t in VOT_TAGS) >= 3
        fails = ours["ar"]["trkB"]["failures"]
        assert sum(sum(f) for f in fails.values()) > 0
        assert os.path.exists(tmp_path / "plots" / "VOT2018_eao.png")
    if name == "LaSOT":
        assert any(np.max(v) > 0 for v in
                   ours["norm_precision"]["trkA"].values())


def test_main_prints_what_jax_prints(root, capsys):
    """The CLI's `main` with `--show_video_level` and `--num 2`."""
    argv = ["--dataset", "OTB2015", "--dataset_dir", root,
            "--tracker_result_dir", os.path.join(root, "results", "OTB2015"),
            "--trackers", *TRACKERS, "--show_video_level", "--num", "2"]
    jax_evaluate.main(argv)
    theirs = capsys.readouterr().out
    port_evaluate.main(argv)
    assert capsys.readouterr().out == theirs
    assert "trkA" in theirs


# -------------------------------------------------------------- statistics

def test_statistics_equal_jax():
    rng = np.random.default_rng(3)
    traj = [[1]] + [list(rng.uniform(0, 50, 4)) for _ in range(20)] + \
        [[2], [0], [0], [0], [0], [1]] + \
        [list(rng.uniform(0, 50, 4)) for _ in range(15)]
    gt = [list(rng.uniform(0, 50, 4)) for _ in traj]
    assert pst.calculate_failures(traj) == jst.calculate_failures(traj)
    for burnin in (0, 3, 10):
        for bound in (None, (60, 60)):
            a = pst.calculate_accuracy(traj, gt, burnin=burnin, bound=bound)
            b = jst.calculate_accuracy(traj, gt, burnin=burnin, bound=bound)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    r1, r2 = rng.uniform(0, 40, (30, 4)), rng.uniform(0, 40, (30, 4))
    r2[3] = 0
    np.testing.assert_array_equal(pst.overlap_ratio(r1, r2),
                                  jst.overlap_ratio(r1, r2))
    np.testing.assert_array_equal(pst.success_overlap(r1, r2, 30),
                                  jst.success_overlap(r1, r2, 30))
    th = np.arange(0, 51, 1)
    np.testing.assert_array_equal(
        pst.success_error(r1[:, :2], r2[:, :2], th, 30),
        jst.success_error(r1[:, :2], r2[:, :2], th, 30))
    scores = rng.random(300)
    scores[::17] = np.nan
    np.testing.assert_array_equal(pst.determine_thresholds(scores),
                                  jst.determine_thresholds(scores))
    thresholds = jst.determine_thresholds(scores)[::-1]
    overlaps = rng.random(300)
    overlaps[::11] = np.nan
    for a, b in zip(pst.calculate_f1(overlaps, scores, (60, 60), thresholds,
                                     250),
                    jst.calculate_f1(overlaps, scores, (60, 60), thresholds,
                                     250)):
        np.testing.assert_array_equal(a, b)
    fragments = rng.random((7, 40))
    fragments[2, 25:] = np.nan
    fragments[5, 10:] = np.nan
    weights = rng.random(7)
    np.testing.assert_array_equal(
        pst.calculate_expected_overlap(fragments, weights),
        jst.calculate_expected_overlap(fragments, weights))


def test_region_traj_and_float2str_equal_jax():
    from usot_tpu.eval import region as jax_region

    rng = np.random.default_rng(4)
    p1 = [list(rng.uniform(0, 50, 4)) for _ in range(12)] + [[0], [1]]
    p2 = [list(rng.uniform(0, 50, 8)) for _ in range(14)]
    for bounds in (None, (40, 30), (2, 3, 45, 38)):
        np.testing.assert_array_equal(
            port_region.vot_overlap_traj(p1, p2, bounds),
            jax_region.vot_overlap_traj(p1, p2, bounds))
    assert port_region.vot_float2str("%.3f", 0.12345) == \
        jax_region.vot_float2str("%.3f", 0.12345) == "0.123"


# -------------------------------------------------------------- frame size

@pytest.mark.parametrize("kind", ["png-rgb", "png-gray", "png-rgba",
                                  "jpeg-rgb", "jpeg-gray",
                                  "jpeg-progressive", "jpeg-exif"])
def test_image_size_equals_pil(tmp_path, kind):
    from PIL import Image

    rng = np.random.default_rng(len(kind))
    h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
    mode = {"gray": "L", "rgba": "RGBA"}.get(kind.split("-")[1], "RGB")
    ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    arr = (rng.random((h, w, ch)) * 255).astype(np.uint8)
    im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    path = str(tmp_path / ("a.png" if kind.startswith("png") else "a.jpg"))
    if kind == "jpeg-progressive":
        im.save(path, progressive=True, quality=80)
    elif kind == "jpeg-exif":
        exif = Image.Exif()
        exif[0x0112] = 6  # an orientation tag: PIL's size stays the raw
        im.save(path, exif=exif)
    else:
        im.save(path)
    with Image.open(path) as ref:
        assert port_datasets._image_size(path) == ref.size == (w, h)


def test_image_size_names_a_file_it_cannot_read(tmp_path):
    path = tmp_path / "frame.bmp"
    path.write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="frame.bmp"):
        port_datasets._image_size(str(path))
    trunc = tmp_path / "cut.jpg"
    trunc.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF")
    with pytest.raises(ValueError, match="cut.jpg"):
        port_datasets._image_size(str(trunc))


# -------------------------------------------------------------- plots

def test_vis_writes_figures(root, tmp_path):
    out = tmp_path / "plots"
    port_evaluate.evaluate("OTB2015", root,
                           os.path.join(root, "results", "OTB2015"),
                           TRACKERS, vis=True, plot_dir=str(out))
    names = sorted(os.listdir(out))
    assert "OTB2015_ALL.png" in names and "OTB2015_ALL_precision.png" \
        in names
    port_evaluate.evaluate("VOT2018-LT", root,
                           os.path.join(root, "results", "VOT2018-LT"),
                           TRACKERS, vis=True, plot_dir=str(out))
    assert os.path.exists(out / "VOT2018-LT_f1.png")


def test_vis_without_matplotlib_raises(root, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        port_evaluate.main([
            "--dataset", "OTB2015", "--dataset_dir", root,
            "--tracker_result_dir", os.path.join(root, "results",
                                                 "OTB2015"),
            "--trackers", *TRACKERS, "--vis", "--plot_dir",
            str(tmp_path / "plots")])
    assert not (tmp_path / "plots").exists()
    # scoring alone needs no matplotlib
    port_evaluate.evaluate("OTB2015", root,
                           os.path.join(root, "results", "OTB2015"),
                           TRACKERS)
