"""The port's sharded `BatchScanEngine(mesh=...)` on the CPU, against JAX's
`BatchScanEngine(mesh=make_mesh(n_data=2))` and against the port's own
unsharded engine.

A mesh of two CPU devices (`make_mesh(devices=["cpu", "cpu"])`) splits
B=4 lanes into two shards of 2, each an engine of its own; JAX's engine
shards the same lanes over two of its virtual CPU devices. The trained
w8c32 fixture tracks the noise-and-square video of `tests/test_tracker.py`
(320x320); JAX's engines crop their init frame with the port's
`get_subwindow`, as in `test_torch_port_engine.py`. Tolerances:
* sharded against unsharded, in each package: JAX's own mesh tolerance,
  2e-3 px (`tests/test_engine.py:795-796`); the port measures 0 on the
  CPU (the same ops on each shard's rows), the scores and the gathered
  carry too;
* the port's sharded engine against JAX's sharded engine: 2.5e-2 px
  (`XPKG_PX`) and the cross-package score tolerance of
  `test_torch_port_engine.py`, 6e-5. The packages' f32 backbones already
  part the tracks by 1.03e-2 px over 20 frames (measured), so JAX's 2e-3
  holds within a package, not across the two; the split's effect
  (sharded minus unsharded) is held at 2e-3 across the packages;
* lane surgery across the shard boundary, the VOT restart and refill
  protocols and ROI streaming: bitwise the unsharded engine's.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import usot_tpu.tracker.engine as jax_engine
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.parallel.mesh import make_mesh as jax_make_mesh
from usot_tpu.tracker.config import TrackerConfig as JaxConfig
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.parallel.mesh import make_mesh
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.engine import (BatchScanEngine, EngineState,
                                           MeshState)
from usot_tpu_torch.tracker.lockstep import run_refill_group, run_vot_group
from usot_tpu_torch.tracker.runner import ModelRunner

from test_tracker import synthetic_video
from torch_port_common import load_fixture

torch.set_num_threads(2)
SIZE, B = 320, 4
BOX = np.array([48.0, 48.0])
MESH_TOL = 2e-3
# the port's engine against JAX's: 2.4x the largest gap measured on the
# CPU (1.03e-2 px over 20 frames; sizes 2.9e-3 px)
XPKG_PX = 2.5e-2


def _config(cls):
    p = cls()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


@pytest.fixture(scope="module")
def fx():
    kw, v = load_fixture()
    pm = build_usot(fused_xcorr=True, **kw)
    runner = ModelRunner(pm, state_dict_from_flax(v), device="cpu")
    jm = jax_build(**kw)
    return SimpleNamespace(pm=pm, runner=runner, jm=jm, v=v,
                           jr=JaxRunner(jm, v))


def _engine(fx, sharded, chunk=8, max_frames=8, batch=B):
    kw = dict(mesh=make_mesh(devices=["cpu", "cpu"])) if sharded \
        else dict(device="cpu")
    return BatchScanEngine(fx.pm, _config(TrackerConfig), SIZE, SIZE,
                           batch=batch, max_frames=max_frames, chunk=chunk,
                           **kw)


def _ragged():
    frames, centers = synthetic_video(n_frames=21)
    videos = [(frames[0], np.array(centers[0], float), BOX)] * B
    stack = np.stack([np.stack(frames[1:])] * B)
    return videos, stack, np.array([20, 20, 13, 7])


@pytest.fixture(scope="module")
def tracks(fx):
    """The ragged batch through the port's sharded and unsharded engines
    and JAX's."""
    videos, stack, n_valid = _ragged()
    out = {}
    for sharded in (True, False):
        eng = _engine(fx, sharded)
        st, *res = eng.track_batch(eng.init_batch(videos, fx.runner),
                                   stack, n_valid)
        out[sharded] = (st, eng.gather_state(st), *res)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        for key, mesh in (("jax", jax_make_mesh(n_data=2)),
                          ("jax_unsharded", None)):
            j_eng = jax_engine.BatchScanEngine(
                fx.jm, fx.v, _config(JaxConfig), SIZE, SIZE, batch=B,
                max_frames=8, chunk=8, impl="native", mesh=mesh)
            out[key] = j_eng.track_batch(j_eng.init_batch(videos, fx.jr),
                                         stack, n_valid)
    return n_valid, out


def test_sharded_engine_matches_unsharded(tracks):
    """Positions, sizes and scores within JAX's mesh tolerance of the
    unsharded engine (measured bitwise), the gathered carry too; the
    carry is one `EngineState` per shard."""
    n_valid, out = tracks
    st, gathered, pos, sz, score = out[True]
    _, plain, pos_u, sz_u, score_u = out[False]
    assert isinstance(st, MeshState) and len(st.shards) == 2
    assert all(isinstance(s, EngineState) and s.pos.shape == (2, 2)
               for s in st.shards)
    for a, b in ((pos, pos_u), (sz, sz_u), (score, score_u)):
        np.testing.assert_allclose(a, b, atol=MESH_TOL, rtol=0)
    np.testing.assert_allclose(st.pos.numpy(), plain.pos.numpy(),
                               atol=MESH_TOL, rtol=0)
    np.testing.assert_array_equal(gathered.mem_idx.numpy(),
                                  plain.mem_idx.numpy())
    np.testing.assert_array_equal(gathered.mem_len.numpy(), n_valid + 1)
    np.testing.assert_allclose(gathered.mem_conf.numpy(),
                               plain.mem_conf.numpy(), atol=1e-6, rtol=0)
    for a, b in zip(gathered.mem_enc, plain.mem_enc):
        assert a.shape == b.shape


def test_sharded_engine_matches_jax_mesh_engine(tracks):
    """Against JAX's engine on the same 2-device split: every valid
    frame within `XPKG_PX` and 6e-5 in score, the final ring bookkeeping
    equal, finished lanes frozen; and the split's own effect (sharded
    minus unsharded) in the port within JAX's mesh tolerance of JAX's."""
    n_valid, out = tracks
    st, gathered, pos, sz, score = out[True]
    j_st, j_pos, j_sz, j_score = out["jax"]
    _, _, pos_u, sz_u, score_u = out[False]
    _, j_pos_u, j_sz_u, j_score_u = out["jax_unsharded"]
    for lane, n in enumerate(n_valid):
        assert np.linalg.norm(pos[lane, :n] - j_pos[lane, :n],
                              axis=1).max() <= XPKG_PX
        np.testing.assert_allclose(sz[lane, :n], j_sz[lane, :n],
                                   atol=XPKG_PX, rtol=0)
        for a, a_u, b, b_u in ((pos, pos_u, j_pos, j_pos_u),
                               (sz, sz_u, j_sz, j_sz_u),
                               (score, score_u, j_score, j_score_u)):
            np.testing.assert_allclose(a[lane, :n] - a_u[lane, :n],
                                       b[lane, :n] - b_u[lane, :n],
                                       atol=MESH_TOL, rtol=0)
        np.testing.assert_allclose(score[lane, :n], j_score[lane, :n],
                                   atol=6e-5, rtol=0)
        np.testing.assert_array_equal(st.pos[lane].numpy(),
                                      pos[lane, n - 1])
    np.testing.assert_array_equal(gathered.mem_idx.numpy(),
                                  np.asarray(j_st.mem_idx))
    np.testing.assert_allclose(gathered.mem_conf.numpy(),
                               np.asarray(j_st.mem_conf), atol=6e-5, rtol=0)


def test_batch_must_divide_the_mesh(fx):
    with pytest.raises(ValueError, match="divide"):
        _engine(fx, True, batch=3)


def test_one_device_mesh_is_the_plain_engine(fx):
    eng = BatchScanEngine(fx.pm, _config(TrackerConfig), SIZE, SIZE,
                          batch=2, max_frames=8, chunk=4,
                          mesh=make_mesh(devices=["cpu"]))
    videos, _, _ = _ragged()
    assert eng._shards is None
    assert isinstance(eng.init_batch(videos[:2], fx.runner), EngineState)


def test_splice_across_the_shard_boundary(fx):
    """`splice_lanes` into lanes 1 and 2 (one in each shard) and
    `splice_lane` into lane 3, mid-run from a kept `run_chunk(donate=
    False)` state: the tracks after equal the unsharded engine's doing
    the same, and the kept state is bitwise unchanged."""
    frames, centers = synthetic_video(n_frames=13)
    other, ocent = synthetic_video(n_frames=13, seed=3)
    videos = [(frames[0], np.array(centers[0], float), BOX)] * B
    block = np.stack([np.stack(frames[1:7])] * B)          # (B, 6, ...)
    rest = np.stack([np.stack(other[6:12])] * B)
    out = {}
    for sharded in (True, False):
        eng = _engine(fx, sharded, chunk=6, max_frames=16)
        st = eng.init_batch(videos, fx.runner)
        blk = torch.from_numpy(np.ascontiguousarray(block.swapaxes(0, 1)))
        valid = torch.ones((6, B), dtype=torch.bool)
        st, _ = eng.run_chunk(st, blk, valid, donate=True)
        kept = [t.clone() for t in _leaves(eng.gather_state(st))]
        _, outs = eng.run_chunk(st, blk, valid, donate=False)
        assert all(torch.equal(a, b) for a, b in
                   zip(kept, _leaves(eng.gather_state(st))))
        inits = [(other[5], np.array(ocent[5], float), BOX)] * 2
        st = eng.splice_lanes(st, [1, 2], eng.make_lane_states(inits,
                                                               fx.runner))
        st = eng.splice_lane(st, 3, eng.make_lane_state(
            other[5], np.array(ocent[5], float), BOX, fx.runner))
        out[sharded] = eng.track_batch(st, rest, np.full(B, 6))
    for a, b in zip(out[True][1:], out[False][1:]):
        np.testing.assert_allclose(a, b, atol=MESH_TOL, rtol=0)
    for a, b in zip(_leaves(_engine(fx, True).gather_state(out[True][0])),
                    _leaves(out[False][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=MESH_TOL, rtol=0)


def _leaves(state):
    out = []
    for f in state:
        out += _leaves(f) if isinstance(f, tuple) else [f]
    return out


def _forced_failure_video(n, fail_frames, seed):
    """`test_lockstep._forced_failure_video`: full-canvas boxes always
    overlap, a box off the canvas never does."""
    frames, centers = synthetic_video(n_frames=n, seed=seed)
    restarts = {f + 5 for f in fail_frames}
    gt = []
    for f in range(n):
        cx, cy = centers[f]
        if f == 0 or f in restarts:
            gt.append([cx - 24.0, cy - 24.0, 48.0, 48.0])
        elif f in fail_frames:
            gt.append([SIZE + 50.0, SIZE + 50.0, 20.0, 20.0])
        else:
            gt.append([0.0, 0.0, float(SIZE), float(SIZE)])
    return frames, gt


def test_vot_and_refill_protocols_on_a_mesh(fx):
    """`tracker/lockstep.py` on the sharded engine: the VOT restart
    protocol (restarts on lanes 1 and 2, either side of the boundary)
    and lane refill give the unsharded engine's rows and tracks."""
    vids = [_forced_failure_video(12, ff, seed=vi)
            for vi, ff in enumerate(([], [2], [3], []))]
    canvases = [np.stack(frames) for frames, _ in vids]
    gts = [gt for _, gt in vids]
    res = {s: run_vot_group(_engine(fx, s, chunk=4, max_frames=16),
                            fx.runner, canvases, [(SIZE, SIZE)] * B, gts)
           for s in (True, False)}
    for a, b in zip(res[True], res[False]):
        assert [isinstance(x, int) and x for x in a.regions] == \
            [isinstance(x, int) and x for x in b.regions]
        for x, y in zip(a.regions, b.regions):
            if not isinstance(x, int):
                np.testing.assert_allclose(x, y, atol=MESH_TOL, rtol=0)
    assert any(2 in [x for x in r.regions if isinstance(x, int)]
               for r in res[True][1:3])

    videos = []
    for vi, n in enumerate([9, 4, 4, 4, 4, 4]):
        frames, centers = synthetic_video(n_frames=n, seed=vi)
        videos.append(dict(name=f"v{vi}", canvas=np.stack(frames), h=SIZE,
                           w=SIZE, init_pos=np.array(centers[0], float),
                           init_sz=BOX))
    refill = {s: run_refill_group(_engine(fx, s, chunk=4, max_frames=16),
                                  fx.runner, videos) for s in (True, False)}
    for name, tracked in refill[True].items():
        for a, b in zip(tracked, refill[False][name]):
            np.testing.assert_allclose(a, b, atol=MESH_TOL, rtol=0)


@pytest.mark.parametrize("roi", [288, 160])
def test_track_batch_roi_on_a_mesh(fx, roi):
    """ROI streaming on the sharded engine, one ROI decision for all
    lanes: bitwise the sharded engine's own full-frame tracks, within
    the mesh tolerance of the unsharded engine's ROI run, and the same
    accept / replay counts."""
    frames, centers = synthetic_video(n_frames=11)
    frames_b, cb = synthetic_video(n_frames=11, seed=4)
    videos = [(frames[0], np.array(centers[0], float), BOX),
              (frames_b[0], np.array(cb[0], float), BOX)] * 2
    stack = np.stack([np.stack(frames[1:]), np.stack(frames_b[1:])] * 2)
    n_valid = np.array([10, 7, 9, 10])
    runs = {}
    for sharded in (True, False):
        eng = _engine(fx, sharded, chunk=3, max_frames=32)
        st = eng.init_batch(videos, fx.runner)
        eng.warm_roi(st, roi)
        _, *roi_out = eng.track_batch_roi(st, stack, n_valid, roi=roi)
        runs[sharded] = (eng, roi_out)
    eng, roi_out = runs[True]
    _, *full = eng.track_batch(eng.init_batch(videos, fx.runner), stack,
                               n_valid)
    for lane, n in enumerate(n_valid):
        for a, b, u in zip(roi_out, full, runs[False][1]):
            np.testing.assert_array_equal(a[lane, :n], b[lane, :n])
            np.testing.assert_allclose(a[lane, :n], u[lane, :n],
                                       atol=MESH_TOL, rtol=0)
    plain = runs[False][0]
    assert (eng.roi_chunks, eng.roi_replays, eng.roi_accepted) == \
        (plain.roi_chunks, plain.roi_replays, plain.roi_accepted)
    assert eng.roi_chunks >= 1 and (roi == 288) == (eng.roi_replays == 0)
