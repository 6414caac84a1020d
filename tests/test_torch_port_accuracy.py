"""The port's accuracy tool (`usot_tpu_torch.tools.accuracy_parity_run`)
on the CPU: its benchmark draws against the repo tool's, and its OPE
against JAX's test CLI and evaluation on the same weights.

The weights are the committed trained fixture (w8c32, its memory queue
of 2) saved as the port's `.pth`, which JAX's `cli.test` reads through `load_variables`.
The benchmark is the tool's default (6 videos of 40 frames at 360x360);
JAX reads its frames from PNG files (the arrays exactly), the port from
memory. Both packages' crops are the port's `get_subwindow` (JAX's is
OpenCV's, a pixel apart; see `test_torch_port_engine.py`).

Held, for the parity tracker and the batch engine (f32) alike: on these
noise frames the fixture's score maps are flat (~0.49,
`test_torch_port_cli.py`), and the two packages, at most 0.05 px apart
while they agree (the parity tracker 1.4e-3, `PARITY.md:86-87` holds
0.5), part where two cells tie within their f32 gap, the gap jumping
from under 0.1 px to over 0.5 px within two frames; where a tie falls
moves with the CPU's thread count. Held: every video's boxes within
0.1 px until its part, a part that jump, at most a third of the videos
parting, AUC within 5e-3 and precision@20 within 0.03 (one video's
part). Measured here at 2 threads: the parity tracker parts on
1 video of 6 (AUC 2.2e-3, precision@20 0.0208 apart; at 4 threads on
none, AUC equal), the batch engine on 2, at frames 17 and 27 (AUC
equal, precision@20 0.0083 apart).
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from usot_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from usot_tpu_torch.tools import accuracy_parity_run as acc  # noqa: E402

from torch_port_common import load_fixture  # noqa: E402

torch.set_num_threads(2)
VIDEOS, FRAMES = 6, 40


def test_build_benchmark_draws_equal_jax(tmp_path, monkeypatch):
    """The port's frames are the arrays the repo tool hands to
    `cv2.imwrite`, and its OTB2015.json is the tool's."""
    import cv2

    from tools.accuracy_parity_run import build_benchmark as jax_build

    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, im: written.setdefault(
        os.path.normpath(path), im.copy()) is not None)
    jax_build(str(tmp_path / "jax"), VIDEOS, FRAMES)
    reader = acc.build_benchmark(str(tmp_path / "port"), VIDEOS, FRAMES)
    assert len(written) == VIDEOS * FRAMES
    for path, im in written.items():
        ours = reader(path.replace(str(tmp_path / "jax"),
                                   str(tmp_path / "port")))
        np.testing.assert_array_equal(ours, im, err_msg=path)
    assert json.loads((tmp_path / "port" / "OTB2015.json").read_text()) == \
        json.loads((tmp_path / "jax" / "OTB2015.json").read_text())


def _jax_ope(root, pth, width, channels, mem_size, engines):
    """JAX's `cli.test` and `cli.evaluate` on the tool's benchmark under
    `root` (frames as PNG files), both packages' crops the port's:
    {(engine, dtype): {"auc", "precision20"}}, result tags
    `JAX_<engine>[_bf16]`."""
    import cv2

    import usot_tpu.tracker.engine as jax_engine
    import usot_tpu.tracker.tracker as jax_tracker
    from usot_tpu.cli.evaluate import evaluate as jax_evaluate
    from usot_tpu.cli.test import main as jax_test
    from usot_tpu_torch.core.crop import get_subwindow

    reader = acc.build_benchmark(root, VIDEOS, FRAMES)
    with open(os.path.join(root, "OTB2015.json")) as f:
        meta = json.load(f)
    for m in meta.values():
        for name in m["img_names"]:
            path = os.path.join(root, "OTB2015", name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            ok, buf = cv2.imencode(".png", reader(path))
            with open(path, "wb") as f:
                f.write(buf.tobytes())
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        mp.setattr(jax_tracker, "get_subwindow", get_subwindow)
        for engine, dtype in engines:
            tag = f"JAX_{engine}" + ("_bf16" if dtype == "bfloat16" else "")
            jax_test(["--dataset", "OTB2015", "--dataset_root", root,
                      "--resume", pth, "--engine", engine,
                      "--dtype", dtype, "--batch", str(VIDEOS),
                      "--arch", tag, "--width", str(width),
                      "--channels", str(channels),
                      "--mem_size", str(mem_size),
                      "--result_dir", os.path.join(root, "result")])
            res = jax_evaluate("OTB2015", root,
                               os.path.join(root, "result", "OTB2015"),
                               [tag])
            out[engine, dtype] = {
                "auc": float(np.mean(list(res["success"][tag].values()))),
                "precision20": float(np.mean(
                    list(res["precision"][tag].values()), axis=0)[20])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's tool on the fixture, and JAX's `cli.test` (parity and
    batch, float32) with `cli.evaluate` on the same benchmark."""
    tmp = tmp_path_factory.mktemp("accuracy")
    kw, variables = load_fixture()
    pth = str(tmp / "fixture.pth")
    torch.save({"state_dict": state_dict_from_flax(variables)}, pth)
    port = acc.run(acc.parse_args([
        "--ckpt", pth, "--root", str(tmp / "port"), "--width", "8",
        "--channels", "32", "--mem_size", str(kw["mem_size"]),
        "--device", "cpu"]))
    jax = _jax_ope(str(tmp / "jax"), pth, 8, 32, kw["mem_size"],
                   (("parity", "float32"), ("batch", "float32")))
    return SimpleNamespace(tmp=tmp, port=port,
                           jax={e: r for (e, _), r in jax.items()})


def _boxes(runs, side, tag):
    base = runs.tmp / side / "result" / "OTB2015" / tag
    return [np.loadtxt(base / f"Syn{v:02d}.txt", delimiter=",")
            for v in range(VIDEOS)]


def _hold_tracks(runs, engine, tag):
    """The module docstring's hold: every video's boxes within 0.1 px of
    JAX's until they part, a part crossing from 0.1 to over 0.5 px within
    two frames (a tie's jump, not a drift), at most a third of the videos
    parting."""
    parted = 0
    for v, (ours, want) in enumerate(zip(
            _boxes(runs, "port", tag),
            _boxes(runs, "jax", f"JAX_{engine}"))):
        assert ours.shape == want.shape == (FRAMES, 4)
        gap = np.abs(ours - want).max(axis=1)
        off = np.nonzero(gap > 0.1)[0]
        if len(off):
            parted += 1
            f = off[0]
            assert f > 0 and gap[f:f + 2].max() > 0.5, \
                (f"Syn{v:02d}: drifted apart, not a tie", gap[:f + 2])
    assert parted <= VIDEOS // 3, parted


@pytest.mark.parametrize("engine,tag", [("parity", "USOT_parity"),
                                        ("batch", "USOT_batch_f32")])
def test_ope_matches_jax(runs, engine, tag):
    _hold_tracks(runs, engine, tag)
    ours, want = runs.port[tag], runs.jax[engine]
    assert abs(ours["auc"] - want["auc"]) <= 5e-3, (ours, want)
    assert abs(ours["precision20"] - want["precision20"]) <= 0.03, \
        (ours, want)


def test_tool_scores_every_run(runs):
    """Four runs scored (every video; `score` raises otherwise), the
    gaps to the parity tracker as computed, and the trained fixture far
    above calibrated random weights."""
    res = runs.port
    for _, _, tag, _ in acc.RUNS:
        assert 0.0 <= res[tag]["auc"] <= 1.0
        assert 0.0 <= res[tag]["precision20"] <= 1.0
    for tag in ("USOT_batch_f32", "USOT_batch_bf16"):
        for k in ("auc", "precision20"):
            assert res[f"delta_{tag}"][k] == pytest.approx(
                abs(res["USOT_parity"][k] - res[tag][k]), abs=1e-12)
    assert res["USOT_parity"]["auc"] > res["USOT_random"]["auc"] + 0.2


@pytest.mark.slow
def test_card_trained_weights_ope_equal_jax(tmp_path):
    """The full-width weights the full schedule trains on the card
    (`regen_bench_ckpt`'s `checkpoint_e30.pth`, bitwise the same on every
    run there; give its path as USOT_TRAINED_PTH): the port's accuracy
    tool on the CPU against JAX's CLI, parity and batch in f32 and bf16,
    held as `test_ope_matches_jax` holds the fixture. Prints both
    packages' figures (the JAX side of `PERF.md`'s accuracy table).
    Marked slow: full width on the CPU takes minutes per engine."""
    pth = os.environ.get("USOT_TRAINED_PTH")
    if not pth or not os.path.exists(pth):
        pytest.skip("USOT_TRAINED_PTH: the card-trained checkpoint_e30.pth")
    port = acc.run(acc.parse_args([
        "--ckpt", pth, "--root", str(tmp_path / "port"), "--device", "cpu"]))
    jax = _jax_ope(str(tmp_path / "jax"), pth, 64, 256, 4,
                   (("parity", "float32"), ("batch", "float32"),
                    ("batch", "bfloat16")))
    print("port", json.dumps(port))
    print("jax", json.dumps({f"{e} {d}": r for (e, d), r in jax.items()}))
    runs = SimpleNamespace(tmp=tmp_path, port=port,
                           jax={e: r for (e, d), r in jax.items()
                                if d == "float32"})
    for engine, tag in (("parity", "USOT_parity"),
                        ("batch", "USOT_batch_f32")):
        _hold_tracks(runs, engine, tag)
        assert abs(port[tag]["auc"] - runs.jax[engine]["auc"]) <= 5e-3
