"""The port's lockstep protocol bench (`usot_tpu_torch.tools.
bench_lockstep`) and `run_vot_group(staged_blocks=)`, on the CPU.

* The benchmark is the JAX tool's (`tools/bench_lockstep.py`), array for
  array: its video generator, and the forced-failure ground truth and
  the refill pool it hands to `run_vot_group` / `run_refill_group`
  (captured from the JAX tool's own `bench_vot` / `bench_refill` with the
  drivers stubbed).
* On that benchmark (480x640, B=2, 24 frames, chunk 8, 2 forced
  failures; a 6-video pool of 24 / 8 frames) the port's protocols against
  JAX's on the trained fixture in float32, at the tolerance of
  `tests/test_torch_port_protocols.py`: the restart skeleton identical
  (restarts counted as JAX counts them), boxes within 0.5 px; the refill
  tracks within 0.5 px and the same number of refills.
* `staged_blocks=` (blocks staged once, reused) gives rows bitwise those
  of `stage=True`.
* The tool's record on the CPU (bf16, as the tool runs): every forced
  failure counted once per repeat, refill and padded groups tracking the
  same boxes.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import usot_tpu.tracker.engine as jax_engine
import usot_tpu.tracker.lockstep as jax_lockstep
from tools import bench_lockstep as jax_tool
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.config import TrackerConfig as JaxConfig
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.tools import bench_lockstep as tool
from usot_tpu_torch.tracker.lockstep import (run_refill_group, run_vot_group,
                                             stage_vot_blocks)
from usot_tpu_torch.tracker.runner import ModelRunner

from torch_port_common import CHANNELS, FIXTURE, WIDTH, load_fixture

torch.set_num_threads(2)
ARGS = SimpleNamespace(batch=2, frames=24, chunk=8, failures=2, reps=1,
                       videos=6, longs=2)


def _jax_tool_inputs(monkeypatch, args):
    """What the JAX tool's `bench_vot` and `bench_refill` hand to the
    protocol drivers: {"vot": (canvases, hws, gts, instance_size),
    "refill": specs}."""
    seen = {}

    class Engine:
        def __init__(self, *a, **kw):
            pass

        def init_batch(self, *a):
            return None

        def track_batch(self, *a, **kw):
            return None

    def vot(engine, runner, canvases, hws, gts, instance_size, **kw):
        seen["vot"] = (canvases, hws, gts, instance_size)
        return [SimpleNamespace(regions=[1]) for _ in canvases]

    def refill(engine, runner, specs):
        seen["refill"] = specs

    monkeypatch.setattr(jax_tool, "load_model", lambda: (None, None, None))
    monkeypatch.setattr(jax_engine, "BatchScanEngine", Engine)
    monkeypatch.setattr(jax_lockstep, "run_vot_group", vot)
    monkeypatch.setattr(jax_lockstep, "stage_vot_blocks", lambda e, c: {})
    monkeypatch.setattr(jax_lockstep, "run_refill_group", refill)
    jax_tool.bench_vot(args)
    jax_tool.bench_refill(args)
    return seen


def test_video_is_the_jax_tools():
    frames, centers = tool.synthetic_video(30)
    j_frames, j_centers = jax_tool.synthetic_video(30)
    np.testing.assert_array_equal(frames, j_frames)
    assert centers == j_centers


@pytest.mark.parametrize("args", [
    ARGS, SimpleNamespace(batch=4, frames=40, chunk=8, failures=3, reps=1,
                          videos=9, longs=2)], ids=["b2", "b4_two_groups"])
def test_protocol_inputs_are_the_jax_tools(monkeypatch, args):
    seen = _jax_tool_inputs(monkeypatch, args)
    canvases, hws, gts, instance = seen["vot"]
    frames, centers = tool.synthetic_video(args.frames)
    assert instance == tool.config().instance_size == JaxConfig().big_sz
    assert hws == [(tool.H, tool.W)] * args.batch
    for c in canvases:
        np.testing.assert_array_equal(c, frames)
    ours = tool.forced_failure_gts(centers, args.batch, args.failures)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(gts))
    specs = tool.refill_specs(args.videos, args.longs, args.batch,
                              args.frames)
    want = seen["refill"]
    assert [s["name"] for s in specs] == [s["name"] for s in want]
    for s, w in zip(specs, want):
        np.testing.assert_array_equal(s["canvas"], w["canvas"])
        assert (s["h"], s["w"]) == (w["h"], w["w"])
        np.testing.assert_array_equal(s["init_pos"], w["init_pos"])
        np.testing.assert_array_equal(s["init_sz"], w["init_sz"])


@pytest.fixture(scope="module")
def models():
    """The port's f32 model and runner and JAX's, on the trained fixture;
    JAX's engines crop their init frame with the port's crop
    (`test_torch_port_protocols.py`)."""
    kw, v = load_fixture()
    pm = build_usot(fused_xcorr=True, **kw)
    runner = ModelRunner(pm, state_dict_from_flax(v), device="cpu")
    jm = jax_build(**kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "get_subwindow", get_subwindow)
    yield SimpleNamespace(pm=pm, runner=runner, jm=jm, v=v,
                          jr=JaxRunner(jm, v))
    mp.undo()


def _jax_config():
    p = JaxConfig()
    p.instance_size = p.big_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def _skeleton(regions):
    return [x if x is None or isinstance(x, int) else "bbox"
            for x in regions]


def _vot_inputs(args=ARGS):
    frames, centers = tool.synthetic_video(args.frames)
    return ([frames] * args.batch, [(tool.H, tool.W)] * args.batch,
            tool.forced_failure_gts(centers, args.batch, args.failures))


def test_vot_protocol_matches_jax(models):
    m = models
    canvases, hws, gts = _vot_inputs()
    engine = tool._engine(m.pm, ARGS.batch, 64, ARGS.chunk, "cpu")
    ours = run_vot_group(engine, m.runner, canvases, hws, gts,
                         staged_blocks=stage_vot_blocks(engine, canvases))
    jp = _jax_config()
    j_eng = jax_engine.BatchScanEngine(m.jm, m.v, jp, tool.H, tool.W,
                                       batch=ARGS.batch, max_frames=64,
                                       chunk=ARGS.chunk, impl="native")
    want = jax_lockstep.run_vot_group(
        j_eng, m.jr, canvases, hws, gts, jp.instance_size,
        small_sz=jp.small_sz, big_sz=jp.big_sz, stage=True)
    assert tool.restarts_of(ours) == tool.restarts_of(want) == ARGS.failures
    assert [r.spill_from for r in ours] == [r.spill_from for r in want]
    for a, j in zip(ours, want):
        assert _skeleton(a.regions) == _skeleton(j.regions)
        for x, y in zip(a.regions, j.regions):
            if _skeleton([x]) == ["bbox"]:
                np.testing.assert_allclose(x, y, atol=0.5, rtol=0)


def test_staged_blocks_are_bitwise_stage_true(models):
    m = models
    canvases, hws, gts = _vot_inputs()
    rows = []
    engine = tool._engine(m.pm, ARGS.batch, 64, ARGS.chunk, "cpu")
    staged = stage_vot_blocks(engine, canvases)
    for kw in (dict(stage=True), dict(staged_blocks=staged),
               dict(staged_blocks=staged)):
        res = run_vot_group(engine, m.runner, canvases, hws, gts, **kw)
        rows.append([[x if x is None or isinstance(x, int)
                      else np.asarray(x).tolist() for x in r.regions]
                     for r in res])
    assert rows[0] == rows[1] == rows[2]


def test_refill_matches_jax(models):
    m = models
    specs = tool.refill_specs(ARGS.videos, ARGS.longs, ARGS.batch,
                              ARGS.frames)
    engine = tool._engine(m.pm, ARGS.batch, 64, ARGS.chunk, "cpu")
    stats = {}
    ours = run_refill_group(engine, m.runner, specs, stats=stats)
    j_eng = jax_engine.BatchScanEngine(m.jm, m.v, _jax_config(), tool.H,
                                       tool.W, batch=ARGS.batch,
                                       max_frames=64, chunk=ARGS.chunk,
                                       impl="native")
    want = jax_lockstep.run_refill_group(j_eng, m.jr, specs)
    assert stats["refills"] == ARGS.videos - ARGS.batch
    assert sorted(ours) == sorted(want)
    for name, (pos, sz, _) in ours.items():
        np.testing.assert_allclose(pos, want[name][0], atol=0.5, rtol=0)
        np.testing.assert_allclose(sz, want[name][1], atol=0.5, rtol=0)


def test_tool_record_on_the_cpu(tmp_path):
    args = tool.parse_args([
        "--vot", "--refill", "--device", "cpu", "--batch", "2", "--frames",
        "24", "--chunk", "8", "--failures", "2", "--reps", "2", "--videos",
        "2", "--longs", "1", "--ckpt", FIXTURE, "--width", str(WIDTH),
        "--channels", str(CHANNELS), "--json", str(tmp_path / "l.json")])
    rec = tool.run(args)
    vot, refill = rec["vot"], rec["refill"]
    assert [r["restarts"] for r in vot["reps"]] == [2, 2]
    assert [r["frames"] for r in vot["reps"]] == [48, 48]
    # a 48-px restart in 480x640 picks small_sz: the restarted lanes spill
    assert vot["spilled"] == [0, 1]
    assert refill["frames"] == 24 + 8 and refill["refills"] == 0
    assert refill["finite"] and refill["box_gap_px"] == 0.0
    assert (tmp_path / "l.json").exists()
