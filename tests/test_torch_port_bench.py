"""The port's headline benchmark (`usot_tpu_torch.tools.bench`) and its
compile watch (`usot_tpu_torch.utils.compile_watch`), on the CPU.

* The watch: a build event fed through the kernel loader's hook
  (`ops/xcorr_kernel.BUILD_LISTENERS`) is attributed to its phase with
  its nvcc seconds; a library found built is a hit with none; the line
  has JAX's shape (`tests/test_misc.py:300`).
* `tools.bench.run` at B=2, 320x288, 17 frames, chunk 8, stream chunk 4
  and 2 staged repeats in f32 on the trained fixture, against JAX's
  `BatchScanEngine` (its default impl, as `bench.py` builds it) driven
  through `bench.py`'s sequence on the same weights and frames: init,
  the warm chunk, the full-frame stream, `suggest_roi` (the same
  answer), the ROI leg, then `stage_frames` and `track_staged` x2.
  Positions and sizes within 0.5 px, scores within 5e-5 per step. The
  canvas is the smallest multiple of 32 px that holds the recipe's
  target (centre (200, 240), 60 px, drifting +24/+11 px): at 160x200 it
  lies off the canvas, and on the fixture's flat response a 3e-5 px gap
  in a corner-clamped position parts the scores by 1.3e-4 in a step.
  `suggest_roi` (352) does not fit the canvas, so that leg is skipped in
  both; a forced window of 256 px is accepted on every chunk, its
  origins clamped to (32, 64), even, where JAX's crop is not a pixel off
  (`test_torch_port_engine.py::test_roi_crop_is_the_full_frame_crop`).
* The JSON line has `bench.py`'s keys, and `main` raises without a GPU
  unless asked for the CPU.
Both engines' init crops use the port's `get_subwindow`
(`test_torch_port_engine.py`).
"""
import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import usot_tpu.tracker.engine as jax_engine
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.config import TrackerConfig as JaxConfig
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.ops import xcorr_kernel
from usot_tpu_torch.tools import bench
from usot_tpu_torch.tracker.engine import synthetic_video
from usot_tpu_torch.utils.compile_watch import CompileWatch

from torch_port_common import CHANNELS, WIDTH, load_fixture

torch.set_num_threads(2)
# BENCH_DTYPE=f32: the engines' f32 tolerances (bf16 is held against JAX's
# bf16 engines in test_torch_port_bf16_engine.py)
KNOBS = dict(frames=17, chunk=8, batch=2, h=320, w=288, stream_chunk=4,
             repeats=2, dtype="f32")


# ---------------------------------------------------------- compile watch

def test_compile_watch_attributes_builds_and_hits(monkeypatch, tmp_path):
    """A phase in which the loader builds K1's library reports one build
    and its nvcc seconds; a second phase that finds it built reports a
    hit and no nvcc seconds; CUDA is not initialised on the CPU."""
    monkeypatch.setattr(xcorr_kernel, "BUILD_LISTENERS", [])
    monkeypatch.setattr(xcorr_kernel, "BUILD_DIR", tmp_path)

    class Proc:  # nvcc, as `_compile` drives it: writes its output file
        returncode = 0

        def __init__(self, cmd, **_):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(xcorr_kernel, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(xcorr_kernel.subprocess, "Popen", Proc)
    ticks = iter([10.0, 12.5])  # the loader's clock around nvcc
    monkeypatch.setattr(xcorr_kernel, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    watch = CompileWatch()
    lines, record = [], []
    with watch.phase("build", lines.append, record):
        xcorr_kernel.build()
    with watch.phase("again", lines.append, record):
        xcorr_kernel.build()
    assert [(r["built"], r["cached"], r["nvcc_s"]) for r in record] == \
        [(1, 0, 2.5), (0, 1, 0.0)]
    assert not any(r["cuda_init"] for r in record)
    assert lines[0].startswith("compile[build]: ")
    assert lines[0].endswith("s wall | kernels: 0 cached + 1 built (2.5s "
                             "nvcc) | cuda init no")
    assert lines[1].startswith("compile[again]: ")
    assert lines[1].endswith("| kernels: 1 cached + 0 built (0.0s nvcc) | "
                             "cuda init no")
    assert watch.snapshot()["built"] == 1


# -------------------------------------------------------- bench.run vs JAX

def _jax_bench(weights_flax, roi):
    """JAX's engine through `bench.py`'s legs (lines 149-255), on the
    fixture and the port's init crop. Returns (the suggested ROI, the
    per-leg (pos, sz, score))."""
    k = KNOBS
    kw, _ = load_fixture()
    jm = jax_build(**kw)
    p = JaxConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    frames = synthetic_video(k["frames"], h=k["h"], w=k["w"])
    b, chunk, sc = k["batch"], k["chunk"], k["stream_chunk"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        engine = jax_engine.BatchScanEngine(
            jm, weights_flax, p, canvas_h=k["h"], canvas_w=k["w"], batch=b,
            max_frames=max(256, k["frames"] + 8), chunk=chunk)
        videos = [(frames[0], np.array([200.0, 240.0]),
                   np.array([60.0, 60.0]))] * b
        state = engine.init_batch(videos, JaxRunner(jm, weights_flax))
    single = np.stack(frames[1:])
    all_frames = np.broadcast_to(single[None], (b,) + single.shape)
    state, *out["warm_chunk"] = engine.track_batch(
        state, all_frames[:, :chunk], n_valid=np.full(b, chunk))
    rest = all_frames[:, chunk:]
    n_rest = rest.shape[1]
    state, *out["fullframe_stream"] = engine.track_batch(
        state, rest, n_valid=np.full(b, n_rest))
    suggested = engine.suggest_roi(state, chunk=sc)
    engine.warm_roi(state, roi, chunk=sc)
    state, _ = engine.run_chunk(
        state, jnp.zeros((sc, b, k["h"], k["w"] * 3), jnp.uint8),
        np.zeros((sc, b), bool))
    state, *out["roi"] = engine.track_batch_roi(
        state, rest, n_valid=np.full(b, n_rest), roi=roi, chunk=sc)
    out["roi_telemetry"] = (engine.roi_chunks, engine.roi_replays,
                            engine.roi_fallback)
    staged = engine.stage_frames(rest, n_valid=np.full(b, n_rest))
    out["staged"] = []
    for _ in range(k["repeats"]):
        state, *o = engine.track_staged(state, staged)
        out["staged"].append(o)
    return suggested, out


@pytest.fixture(scope="module")
def runs():
    _, v = load_fixture()
    weights = state_dict_from_flax(v)
    roi = 256
    port = bench.run(weights, "cpu", roi=str(roi), width=WIDTH,
                     channels=CHANNELS, log=lambda m: None, **KNOBS)
    auto = bench.run(weights, "cpu", roi="auto", width=WIDTH,
                     channels=CHANNELS, log=lambda m: None,
                     **dict(KNOBS, repeats=1))
    suggested, jax_out = _jax_bench(v, roi)
    return port, auto, suggested, jax_out


def _close(ours, want, leg):
    (pos, sz, score), (j_pos, j_sz, j_score) = ours, want
    assert pos.shape == np.asarray(j_pos).shape, leg
    assert np.linalg.norm(pos - j_pos, axis=-1).max() <= 0.5, leg
    np.testing.assert_allclose(sz, j_sz, atol=0.5, rtol=0, err_msg=leg)
    np.testing.assert_allclose(score, j_score, atol=5e-5, rtol=0,
                               err_msg=leg)


def test_bench_legs_track_as_jax(runs):
    port, auto, suggested, jax_out = runs
    assert auto["legs"]["roi"]["roi"] == suggested
    assert auto["legs"]["roi"].get("skipped") is True
    assert suggested >= min(KNOBS["h"], KNOBS["w"])
    tracks = port["tracks"]
    for leg in ("warm_chunk", "fullframe_stream", "roi"):
        _close(tracks[leg], jax_out[leg], leg)
    assert len(tracks["staged"]) == len(jax_out["staged"]) == 2
    for r, (ours, want) in enumerate(zip(tracks["staged"],
                                         jax_out["staged"])):
        _close(ours, want, f"staged repeat {r}")
    roi = port["legs"]["roi"]
    assert (roi["roi_chunks"], roi["roi_replays"], roi["roi_fallback"]) \
        == jax_out["roi_telemetry"] == (2, 0, False)
    assert roi["roi_accepted"] == 2
    # every leg ran and the staged leg's steps are counted
    assert set(port["legs"]) == {"init_batch", "warm_chunk",
                                 "fullframe_stream", "roi", "staged"}
    staged = port["legs"]["staged"]
    assert staged["frame_steps"] == 2 * 8 and len(staged["repeats_fps"]) == 2
    assert staged["k1_launches"] == 0  # the plain version on the CPU
    assert [c["phase"] for c in port["compile"]] == [
        "init_batch", "scan_chunk", "fullframe_stream", "roi_chunk",
        "staged_program"]
    assert all(c["built"] == 0 and c["line"].startswith(
        f"compile[{c['phase']}]: ") for c in port["compile"])


def test_bench_json_line_has_bench_keys(runs):
    port = runs[0]
    line = port["line"]
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "usot_star_tracking_throughput_fps_per_chip"
    assert line["unit"] == "frames/sec"
    assert line["value"] == round(port["legs"]["staged"]["median_fps"], 2)
    assert line["vs_baseline"] == round(line["value"] / 58.0, 3)
    json.dumps({k: v for k, v in port.items() if k != "tracks"})


def test_bench_knobs_and_weights(tmp_path, monkeypatch):
    """`bench.py`'s defaults; BENCH_S2B=1 raises; BENCH_CKPT wins and is
    logged with its sha256; `main` needs `--device cpu` without a GPU."""
    k = bench.knobs({})
    assert k == dict(frames=129, chunk=64, batch=32, mode="staged",
                     dtype="bf16", h=480, w=640, roi="auto", stream_chunk=16,
                     repeats=5, ckpt=None)
    with pytest.raises(ValueError, match="s2b_dilated"):
        bench.knobs({"BENCH_S2B": "1"})
    _, v = load_fixture()
    path = tmp_path / "w.pth"
    torch.save(state_dict_from_flax(v), path)
    weights, used, digest = bench.load_weights(str(path), "cpu")
    assert used == str(path) and len(digest) == 64
    assert set(weights) == set(state_dict_from_flax(v))
    if not torch.cuda.is_available():
        monkeypatch.chdir(tmp_path)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main([], env={})
        assert sorted(p.name for p in tmp_path.iterdir()) == ["w.pth"]
