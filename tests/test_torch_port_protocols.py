"""The port's lane surgery, non-donating chunks, benchmark protocols and ROI
streaming (`usot_tpu_torch.tracker.{engine,lockstep}`) on the CPU,
against `usot_tpu` and against the port's own single-video paths.

The trained fixture's weights go into both packages; frames are the
noise-and-square video of `tests/test_tracker.py`, 320x320. JAX's engines
crop their init frame with the port's `get_subwindow`, as in
`test_torch_port_engine.py` (the two host crops differ by a grey level,
which parts noise-video tracks by more than 0.5 px). Tolerances:
* a spliced lane against a fresh `ScanEngine`: 1e-4 px; the batched
  boundary splice against per-lane splices: 1e-4 px (the lanes' init
  passes run at B=3 instead of B=1); untouched lanes bitwise;
* `run_chunk(donate=False)`: the passed state bitwise unchanged, and a
  replay from it bitwise the same, with the ring filling and full;
* VOT restart and refill: the restart skeleton (1/2/0 rows) identical;
  bbox rows within 0.5 px of JAX's lockstep protocols and within 5e-2 px
  of the port's scan path (`usot_tpu/..` `test_lockstep.py`'s
  tolerance);
* ROI streaming: `suggest_roi` equal to JAX's (host f64 arithmetic);
  `track_batch_roi` within 1e-2 px of `track_batch`
  (`test_integration.py:264`).
The ground truth of the VOT videos forces the failures: full-frame boxes
always overlap, boxes off the canvas never do (`test_lockstep.py:154`).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import usot_tpu.tracker.engine as jax_engine
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.config import TrackerConfig as JaxConfig
from usot_tpu.tracker.lockstep import run_refill_group as jax_refill
from usot_tpu.tracker.lockstep import run_vot_group as jax_vot
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu_torch.cli.test import _scan_vot_loop
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.engine import BatchScanEngine, ScanEngine
from usot_tpu_torch.tracker.lockstep import run_refill_group, run_vot_group

from test_tracker import synthetic_video
from torch_port_common import load_fixture

torch.set_num_threads(2)
SIZE = 320
BOX = np.array([48.0, 48.0])


def _config(cls):
    p = cls()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


@pytest.fixture(scope="module")
def fixture():
    """The port's model and runner, JAX's model, variables and runner, on
    the trained fixture; JAX's engines crop with the port's crop."""
    from usot_tpu_torch.tracker.runner import ModelRunner

    kw, v = load_fixture()
    pm = build_usot(fused_xcorr=True, **kw)
    runner = ModelRunner(pm, state_dict_from_flax(v), device="cpu")
    jm = jax_build(**kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "get_subwindow", get_subwindow)
    yield SimpleNamespace(pm=pm, runner=runner, jm=jm, v=v,
                          jr=JaxRunner(jm, v))
    mp.undo()


def _video(n, seed):
    frames, centers = synthetic_video(n_frames=n, seed=seed)
    return frames, np.array(centers[0], float)


def _batch(fx, b, chunk, max_frames=32):
    return BatchScanEngine(fx.pm, _config(TrackerConfig), SIZE, SIZE,
                           batch=b, max_frames=max_frames, chunk=chunk,
                           device="cpu")


def _host(state):
    """Every tensor of a state as numpy (a copy)."""
    return [t.numpy().copy() for t in _leaves(state)]


def _leaves(state):
    out = []
    for f in state:
        if isinstance(f, tuple):
            out += _leaves(f)
        else:
            out.append(f)
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------- lane surgery

def test_spliced_lane_tracks_like_a_fresh_scan_engine(fixture):
    """Video C spliced into lane 1 of a running batch tracks as a fresh
    single-video engine on C does (restart semantics: the reference
    re-enters tracker.init); lane 0 is bitwise what it is without the
    splice."""
    fx = fixture
    frames_a, pos_a = _video(7, 0)
    frames_c, pos_c = _video(7, 5)
    fb = np.stack([np.stack(frames_a[1:4])] * 2)

    def run(splice):
        eng = _batch(fx, 2, 3)
        st = eng.init_batch([(frames_a[0], pos_a, BOX)] * 2, fx.runner)
        st, _, _, _ = eng.track_batch(st, fb, np.array([3, 3]))
        if splice:
            st = eng.splice_lane(st, 1, eng.make_lane_state(
                frames_c[0], pos_c, BOX, fx.runner))
        second = [np.stack(frames_a[4:]),
                  np.stack(frames_c[1:4] if splice else frames_a[4:])]
        return eng.track_batch(st, np.stack(second), np.array([3, 3]))

    _, pos_b, sz_b, _ = run(True)
    _, pos_0, _, _ = run(False)
    single = ScanEngine(fx.pm, _config(TrackerConfig), SIZE, SIZE,
                        max_frames=32, chunk=3, device="cpu")
    _, pos_s, sz_s, _ = single.track_frames(
        single.init_state(frames_c[0], pos_c, BOX, fx.runner),
        np.stack(frames_c[1:4]))
    np.testing.assert_allclose(pos_b[1], pos_s, atol=1e-4, rtol=0)
    np.testing.assert_allclose(sz_b[1], sz_s, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(pos_b[0], pos_0[0])


def test_splice_writes_exactly_the_lane_state(fixture):
    """A splice writes the lane's pos, sz, encodings, ring slot 0 and
    reset bookkeeping (0.9 / 0 / 1) bitwise from the lane state, and the
    engine's avg and image-size rows; every other lane, and the rest of
    the lane's ring, are bitwise untouched."""
    fx = fixture
    frames, pos0 = _video(5, 0)
    eng = _batch(fx, 3, 4, max_frames=8)
    st = eng.init_batch([(frames[0], pos0, BOX)] * 3, fx.runner)
    st, _, _, _ = eng.track_batch(st, np.stack([np.stack(frames[1:])] * 3),
                                  np.array([4, 4, 4]))
    before = _host(st)
    avg0, hw0 = eng._avg_b.clone(), eng._im_hw_b.clone()
    other, _ = _video(3, 9)
    im = other[0][:200, :300]       # a smaller image on the canvas
    ls = eng.make_lane_states([(im, np.array([150.0, 90.0]),
                                np.array([40.0, 30.0]))], fx.runner)
    st = eng.splice_lanes(st, [2], ls)
    after = _host(st)
    for x, y in zip(before, after):   # lanes 0 and 1
        np.testing.assert_array_equal(x[:2], y[:2])
    np.testing.assert_array_equal(st.pos[2].numpy(), ls["pos"][0])
    np.testing.assert_array_equal(st.sz[2].numpy(), ls["sz"][0])
    for side, want in zip(st.zf_enc, ls["zf_enc"]):
        for t, w in zip(side, want):
            np.testing.assert_array_equal(t[2, 0].numpy(), w[0].numpy())
    for init, ring, f, ring_before in zip(st.init_enc, st.mem_enc,
                                          ls["feat_enc"], before[11:14]):
        np.testing.assert_array_equal(init[2].numpy(), f[:2].numpy())
        np.testing.assert_array_equal(ring[2, 0].numpy(), f[0].numpy())
        np.testing.assert_array_equal(ring[2, 1:].numpy(),
                                      ring_before[2, 1:])
    assert st.mem_conf[2, 0] == np.float32(0.9)
    assert float(st.mem_conf[2, 1:].abs().sum()) == 0.0
    assert st.mem_idx[2].tolist() == [0] + [-1] * 7
    assert st.mem_len.tolist() == [5, 5, 1]
    np.testing.assert_array_equal(eng._avg_b[2].numpy(), ls["avg"][0])
    assert eng._im_hw_b[2].tolist() == [200.0, 300.0]
    np.testing.assert_array_equal(eng._avg_b[:2].numpy(), avg0[:2].numpy())
    np.testing.assert_array_equal(eng._im_hw_b[:2].numpy(), hw0[:2].numpy())


def test_splice_lanes_matches_per_lane_splices(fixture):
    """One batched boundary splice of two lanes against two single-lane
    splices: the untouched lane bitwise equal, the spliced lanes' tracks
    within 1e-4 px (batched init passes instead of B=1 ones)."""
    fx = fixture
    frames_a, pos_a = _video(7, 0)
    frames_c, pos_c = _video(7, 5)
    frames_d, pos_d = _video(7, 9)
    fresh = [(frames_c[0], pos_c, BOX),
             (frames_d[0], pos_d, np.array([40.0, 40.0]))]

    def run(batched):
        eng = _batch(fx, 3, 3)
        st = eng.init_batch([(frames_a[0], pos_a, BOX)] * 3, fx.runner)
        st, _, _, _ = eng.track_batch(
            st, np.stack([np.stack(frames_a[1:4])] * 3), np.array([3] * 3))
        if batched:
            st = eng.splice_lanes(st, [1, 2],
                                  eng.make_lane_states(fresh, fx.runner))
        else:
            for lane, (im, tp, ts) in zip((1, 2), fresh):
                st = eng.splice_lane(st, lane, eng.make_lane_state(
                    im, tp, ts, fx.runner))
        fb2 = np.stack([np.stack(f) for f in
                        (frames_a[4:], frames_c[1:4], frames_d[1:4])])
        return eng.track_batch(st, fb2, np.array([3] * 3))

    _, pos_a1, sz_a1, _ = run(False)
    _, pos_b1, sz_b1, _ = run(True)
    np.testing.assert_array_equal(pos_a1[0], pos_b1[0])
    np.testing.assert_allclose(pos_b1[1:], pos_a1[1:], atol=1e-4, rtol=0)
    np.testing.assert_allclose(sz_b1[1:], sz_a1[1:], atol=1e-4, rtol=0)


# ------------------------------------------------------ donate=False

@pytest.mark.parametrize("ring", ["room", "full"])
def test_non_donating_chunk_leaves_its_state_bitwise(fixture, ring):
    """max_frames 4 with up to 12 frames: the ring has room in the first
    chunk and evicts in the third. The state passed to a donate=False
    chunk is bitwise unchanged after it, a replay from it gives bitwise
    the same outputs and state, and donate=True (the default) writes the
    rings in place."""
    fx = fixture
    frames, pos0 = _video(13, 0)
    eng = _batch(fx, 2, 4, max_frames=4)
    st = eng.init_batch([(frames[0], pos0, BOX)] * 2, fx.runner)
    lanes = np.stack([np.stack(frames[1:])] * 2)      # (2, 12, H, W, 3)
    blocks = [(torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(lanes[:, i:i + 4], 0, 1))),
        torch.from_numpy(np.array([[True, t < 3] for t in range(4)])))
        for i in (0, 4, 8)]
    if ring == "full":
        for block, valid in blocks[:2]:
            st, _ = eng.run_chunk(st, block, valid)
        assert int(st.mem_len.min()) > 4        # every ring full
    block, valid = blocks[2 if ring == "full" else 0]
    before = _host(st)
    st1, out1 = eng.run_chunk(st, block, valid, donate=False)
    _assert_same(_host(st), before)
    st2, out2 = eng.run_chunk(st, block, valid, donate=False)
    _assert_same(_host(st), before)
    _assert_same(_host(st2), _host(st1))
    _assert_same([o.numpy() for o in out2], [o.numpy() for o in out1])
    # the rings of a written state differ from the passed one's
    assert not all(np.array_equal(a, b.numpy()) for a, b in
                   zip(before[11:14], st1.mem_enc))
    st3, out3 = eng.run_chunk(st, block, valid)
    _assert_same([o.numpy() for o in out3], [o.numpy() for o in out1])
    assert all(r3 is r0 for r3, r0 in zip(st3.mem_enc, st.mem_enc))


# ------------------------------------------------------------ VOT restart

def _forced_failure_video(n, fail_frames, seed, spill_at=()):
    """`test_lockstep._forced_failure_video`; a restart at f + 5 for f
    in spill_at carries a 16-px box, which flips the instance size
    (16^2 / 320^2 < 0.004: instance 271, the group's is 255)."""
    frames, centers = synthetic_video(n_frames=n, seed=seed)
    restarts = {f + 5 for f in fail_frames}
    gt = []
    for f in range(n):
        cx, cy = centers[f]
        if f == 0 or f in restarts:
            box = 16 if f - 5 in spill_at else 48
            gt.append([cx - box / 2, cy - box / 2, box, box])
        elif f in fail_frames:
            gt.append([SIZE + 50.0, SIZE + 50.0, 20.0, 20.0])
        else:
            gt.append([0.0, 0.0, float(SIZE), float(SIZE)])
    return frames, gt


def _skeleton(regions):
    return [x if isinstance(x, int) or x is None else "bbox"
            for x in regions]


@pytest.mark.parametrize("chunk,fails,replays", [
    (8, ([2], [], [1]), 1),     # same-chunk restart, a clean lane, a spill
    (4, ([3], [6], [1]), 0),    # cross-chunk re-inits, two failing lanes
])
def test_vot_group_matches_jax_and_the_scan_path(fixture, chunk, fails,
                                                 replays):
    fx = fixture
    n = 16
    vids = [_forced_failure_video(n, ff, seed=vi,
                                  spill_at=ff if vi == 2 else ())
            for vi, ff in enumerate(fails)]
    canvases = [np.stack(frames) for frames, _ in vids]
    gts = [gt for _, gt in vids]
    hws = [(SIZE, SIZE)] * 3
    jp = _config(JaxConfig)
    eng = _batch(fx, 3, chunk, max_frames=64)
    stats = {}
    ours = run_vot_group(eng, fx.runner, canvases, hws, gts, stats=stats)
    j_eng = jax_engine.BatchScanEngine(fx.jm, fx.v, jp, SIZE, SIZE, batch=3,
                                       max_frames=64, chunk=chunk,
                                       impl="native")
    want = jax_vot(j_eng, fx.jr, canvases, hws, gts, jp.instance_size,
                   small_sz=jp.small_sz, big_sz=jp.big_sz)
    assert stats["replays"] == replays
    assert [r.spill_from for r in ours] == [r.spill_from for r in want] \
        == [None, None, fails[2][0] + 5]

    args = SimpleNamespace(chunk=chunk)
    for vi in range(3):
        a, j = ours[vi].regions, want[vi].regions
        assert _skeleton(a) == _skeleton(j), f"video {vi}"
        # the port's scan path from frame 0, and the batched CLI's spill
        # finish from the spill frame
        scan = [None] * n
        _scan_vot_loop(fx.pm, fx.runner, {}, args, vids[vi][0],
                       canvases[vi], gts[vi], scan, 0, True)
        if ours[vi].spill_from is not None:
            a = list(a)
            _scan_vot_loop(fx.pm, fx.runner, {}, args, vids[vi][0],
                           canvases[vi], gts[vi], a, ours[vi].spill_from,
                           True)
        assert _skeleton(a) == _skeleton(scan), f"video {vi}"
        for f in range(n):
            if _skeleton([a[f]]) == ["bbox"]:
                np.testing.assert_allclose(a[f], scan[f], atol=5e-2,
                                           rtol=0, err_msg=f"{vi} {f}")
            if _skeleton([j[f]]) == ["bbox"]:
                np.testing.assert_allclose(ours[vi].regions[f], j[f],
                                           atol=0.5, rtol=0,
                                           err_msg=f"{vi} {f}")


def test_staged_vot_group_is_the_streamed_one(fixture):
    """stage=True uploads every block first; the rows are identical."""
    fx = fixture
    vids = [_forced_failure_video(10, ff, seed=vi)
            for vi, ff in enumerate(([2], []))]
    canvases = [np.stack(frames) for frames, _ in vids]
    rows = []
    for stage in (False, True):
        eng = _batch(fx, 2, 4)
        res = run_vot_group(eng, fx.runner, canvases, [(SIZE, SIZE)] * 2,
                            [g for _, g in vids], stage=stage)
        rows.append([[np.asarray(x).tolist() if x is not None else None
                      for x in r.regions] for r in res])
    assert rows[0] == rows[1]


# ----------------------------------------------------------- lane refill

def test_refill_covers_every_video_like_its_scan_run(fixture):
    """Lengths [13, 4, 4, 4] on 2 lanes: every video tracked, lanes
    refilled 2 times (the 2 longest start, the rest wait), each video's
    track within 5e-2 px of its own ScanEngine run and within 0.5 px of
    JAX's refill."""
    fx = fixture
    lengths = [13, 4, 4, 4]
    videos, raw = [], []
    for vi, n in enumerate(lengths):
        frames, pos0 = _video(n, vi)
        raw.append((frames, pos0))
        videos.append(dict(name=f"v{vi}", canvas=np.stack(frames),
                           h=SIZE, w=SIZE, init_pos=pos0, init_sz=BOX))
    eng = _batch(fx, 2, 4)
    stats = {}
    ours = run_refill_group(eng, fx.runner, videos, stats=stats)
    assert stats["refills"] == 2 and sorted(ours) == ["v0", "v1", "v2",
                                                      "v3"]
    j_eng = jax_engine.BatchScanEngine(fx.jm, fx.v, _config(JaxConfig),
                                       SIZE, SIZE, batch=2, max_frames=32,
                                       chunk=4, impl="native")
    want = jax_refill(j_eng, fx.jr, videos)
    single = ScanEngine(fx.pm, _config(TrackerConfig), SIZE, SIZE,
                        max_frames=32, chunk=4, device="cpu")
    for vi, n in enumerate(lengths):
        frames, pos0 = raw[vi]
        _, pos_s, sz_s, _ = single.track_frames(
            single.init_state(frames[0], pos0, BOX, fx.runner),
            np.stack(frames[1:]))
        pos_r, sz_r, score_r = ours[f"v{vi}"]
        assert pos_r.shape == (n - 1, 2) and score_r.shape == (n - 1,)
        np.testing.assert_allclose(pos_r, pos_s, atol=5e-2, rtol=0)
        np.testing.assert_allclose(sz_r, sz_s, atol=5e-2, rtol=0)
        j_pos, j_sz, _ = want[f"v{vi}"]
        np.testing.assert_allclose(pos_r, j_pos, atol=0.5, rtol=0)
        np.testing.assert_allclose(sz_r, j_sz, atol=0.5, rtol=0)


# ---------------------------------------------------------- ROI streaming

def test_suggest_roi_equals_jax(fixture):
    """Host f64 arithmetic on the same states, the init-span floor
    included: equal sizes."""
    fx = fixture
    frames, pos0 = _video(2, 0)
    videos = [(frames[0], pos0, BOX), (frames[0], pos0 + 30,
                                       np.array([90.0, 20.0]))]
    eng = _batch(fx, 2, 8)
    st = eng.init_batch(videos, fx.runner)
    j_eng = jax_engine.BatchScanEngine(fx.jm, fx.v, _config(JaxConfig),
                                       SIZE, SIZE, batch=2, max_frames=32,
                                       chunk=8)
    j_st = j_eng.init_batch(videos, fx.jr)
    assert eng._init_span == j_eng._init_span
    rng = np.random.default_rng(3)
    for _ in range(40):
        pos = rng.uniform(0, SIZE, (2, 2)).astype(np.float32)
        sz = rng.uniform(5, 200, (2, 2)).astype(np.float32)
        chunk = int(rng.integers(1, 40))
        ours = eng.suggest_roi(st._replace(pos=torch.from_numpy(pos),
                                           sz=torch.from_numpy(sz)), chunk)
        want = j_eng.suggest_roi(j_st._replace(pos=jnp.asarray(pos),
                                               sz=jnp.asarray(sz)), chunk)
        assert ours == want
    assert eng.suggest_roi(st) == j_eng.suggest_roi(j_st)


@pytest.mark.parametrize("roi", [288, 160])
def test_roi_streaming_matches_full_frames(fixture, roi):
    """ROI chunks against full-frame tracking of the same frames, ragged
    lanes, within 1e-2 px. 160 px cannot hold a 48-px target's ~241-px
    crop window: its first chunk replays on full frames and the run
    escalates or hands the rest to full frames."""
    fx = fixture
    frames, pos0 = _video(11, 0)
    frames_b, pos_b = _video(11, 4)
    stack = np.stack([np.stack(frames[1:]), np.stack(frames_b[1:])])
    n_valid = np.array([10, 7])
    videos = [(frames[0], pos0, BOX), (frames_b[0], pos_b, BOX)]
    eng = _batch(fx, 2, 3)
    _, pos_f, sz_f, score_f = eng.track_batch(
        eng.init_batch(videos, fx.runner), stack, n_valid)
    st = eng.init_batch(videos, fx.runner)
    eng.warm_roi(st, roi)
    st, pos, sz, score = eng.track_batch_roi(st, stack, n_valid, roi=roi)
    for lane, n in enumerate(n_valid):
        np.testing.assert_array_equal(pos[lane, :n], pos_f[lane, :n])
        np.testing.assert_array_equal(sz[lane, :n], sz_f[lane, :n])
        np.testing.assert_array_equal(score[lane, :n], score_f[lane, :n])
    np.testing.assert_array_equal(st.mem_len.numpy(), n_valid + 1)
    assert eng.roi_chunks >= 1
    if roi == 160:
        assert eng.roi_replays >= 1
    else:
        assert eng.roi_accepted == eng.roi_chunks and not eng.roi_fallback
        assert eng.roi_bytes_sent < eng.roi_bytes_full_equiv
