"""Port engines (`usot_tpu_torch.tracker.engine`, device crops, folded
head) against `usot_tpu` on the CPU.

Same numpy-seeded inputs and identical weights in both packages:
* device crops within 3e-5 grey levels of `subwindow_jax` /
  `subwindow_matmul`, out-of-image windows and a valid-extent canvas;
* `fold_inference_head` and `track_memory_encoded_fused` within
  scale-aware 1e-4;
* ring logic pick-exact: `_queue_picks` and `_write_slot` over 2000+
  frame confidence traces with ties and a small ring that evicts, and
  `_memory_write_multi_batched` in the shared and diverged regimes with
  invalid lanes;
* `_postprocess_traced` within 1e-5;
* `ScanEngine` and `BatchScanEngine` (B=3, ragged) on the trained
  fixture against JAX's engines: positions and sizes within 0.5 px,
  final `mem_idx` / `mem_len` equal. Scores: within 5e-5 for one frame
  step from the same carry (teacher-forced), within 6e-5 free-running.
  The two packages' f32 backbones differ by ~1.3e-5 (relative, search
  features), which the heads carry into score gaps of up to 3.3e-5 in
  one step; free-running, the position also drifts by hundredths of a
  pixel, the bilinear crop of a noise frame turns that into a different
  crop, and the scores part by more. A 1e-5 limit on scores cannot hold
  across the two packages' f32 arithmetic.
* The engines' host init against JAX's with its own OpenCV crop: crops
  within one grey level, labels equal. On the fixture's noise video the
  two crops part the tracks far beyond 0.5 px, so the whole-engine
  comparisons run JAX's engines on the port's `get_subwindow`.
Each JAX engine is built and run once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import usot_tpu.tracker.engine as jax_engine
from usot_tpu.core.crop import subwindow_jax
from usot_tpu.core.crop import subwindow_matmul as jax_subwindow_matmul
from usot_tpu.models.head import fold_inference_head as jax_fold
from usot_tpu.models.usot import USOTNet as JaxNet
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.config import TrackerConfig as JaxConfig
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu_torch.core.crop import (get_subwindow, subwindow_gather,
                                      subwindow_matmul)
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.head import fold_inference_head
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.tracker import engine
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.runner import ModelRunner

from test_tracker import synthetic_video
from torch_port_common import CHANNELS, WIDTH, load_fixture, random_variables

# Several test workers share the host's cores; tiny shapes need few threads.
torch.set_num_threads(2)


def _config(cls):
    p = cls()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ crops

@pytest.mark.parametrize("impl", ["gather", "matmul"])
def test_device_crop_matches_jax(impl):
    port = {"gather": subwindow_gather, "matmul": subwindow_matmul}[impl]
    ref = {"gather": subwindow_jax, "matmul": jax_subwindow_matmul}[impl]
    rng = np.random.default_rng(5)
    b, h, w = 6, 60, 80
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    # windows inside, across every border, wholly outside, tiny and huge
    pos_x = np.array([40, -20, 95, 10, 300, 40], np.float32)
    pos_y = np.array([30, -15, 70, 50, -200, 31], np.float32)
    size = np.array([33.4, 50.0, 41.6, 12.5, 60.0, 140.0], np.float32)
    avg = rng.uniform(0, 255, (b, 3)).astype(np.float32)
    # a canvas whose valid region is smaller than the frame on some lanes
    vh = np.array([60, 45, 60, 38, 60, 52], np.float32)
    vw = np.array([80, 80, 61, 70, 80, 57], np.float32)
    for s, valid in ((31, False), (64, True)):
        extent = (_t(vh), _t(vw)) if valid else (None, None)
        out = port(_t(frames), _t(pos_x), _t(pos_y), _t(size), _t(avg), s,
                   *extent).numpy()
        want = np.stack([np.asarray(ref(
            jnp.asarray(frames[i].reshape(h, w * 3)), pos_x[i], pos_y[i],
            size[i], jnp.asarray(avg[i]), s,
            valid_h=vh[i] if valid else None,
            valid_w=vw[i] if valid else None, channels=3))
            for i in range(b)])
        assert out.shape == (b, s, s, 3) and out.dtype == np.float32
        np.testing.assert_allclose(out, want, atol=3e-5, rtol=0)


def test_roi_crop_is_the_full_frame_crop():
    """The crop of an ROI window at its origin against the crop of the
    full frame: bitwise equal. Lanes 0 and 3 have window corners that
    round half to even (79.5 -> 80, 63.5 -> 64) and odd origins, where
    a window-relative corner (48.5 -> 48, 44.5 -> 44) would be a pixel
    off; lane 1 has an even origin, lane 2 a fractional position."""
    rng = np.random.default_rng(7)
    b, h, w, roi, s = 4, 200, 260, 150, 64
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    pos_x = _t(np.array([120.0, 121.0, 130.37, 99.5], np.float32))
    pos_y = _t(np.array([100.0, 101.0, 88.81, 110.5], np.float32))
    size = _t(np.array([80.0, 80.0, 61.0, 71.0], np.float32))
    origin = np.array([[31, 47], [32, 46], [45, 17], [19, 33]])
    avg = _t(rng.uniform(0, 255, (b, 3)).astype(np.float32))
    windows = np.stack([frames[v, oy:oy + roi, ox:ox + roi]
                        for v, (ox, oy) in enumerate(origin)])
    full = subwindow_gather(_t(frames), pos_x, pos_y, size, avg, s)
    part = subwindow_gather(
        _t(windows), pos_x, pos_y, size, avg, s,
        valid_h=_t(np.minimum(h - origin[:, 1], roi).astype(np.float32)),
        valid_w=_t(np.minimum(w - origin[:, 0], roi).astype(np.float32)),
        origin=_t(origin.astype(np.float32)))
    np.testing.assert_array_equal(part.numpy(), full.numpy())


def test_matmul_crop_ignores_tf32_flag():
    """The matmul crop switches TF32 off for itself and restores the
    global flag afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rng = np.random.default_rng(6)
        frames = _t(rng.integers(0, 256, (1, 20, 30, 3), dtype=np.uint8))
        one = torch.ones(1)
        subwindow_matmul(frames, one * 12, one * 9, one * 15,
                         torch.zeros(1, 3), 16)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ----------------------------------------------------------- folded head

@pytest.fixture(scope="module", params=["random", "fixture"])
def models(request):
    v = random_variables(4) if request.param == "random" \
        else load_fixture()[1]
    jm = jax_build(mem_size=2, width=WIDTH, channels=CHANNELS)
    pm = build_usot(mem_size=2, width=WIDTH, channels=CHANNELS,
                    fused_xcorr=True)
    pm.load_state_dict(state_dict_from_flax(v))
    return jm, v, pm.eval()


def _close(ours, ref, tol=1e-4):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1.0))


def test_fold_inference_head_matches_jax(models):
    _, v, pm = models
    ref = jax_fold(v)
    ours = fold_inference_head(pm.connect_model)
    for (w, b), (jw, jb) in zip(ours["encoders"] + [ours["conf_value"]],
                                ref["encoders"] + [ref["conf_value"]]):
        _close(w.permute(2, 3, 1, 0), jw)   # OIHW -> HWIO
        _close(b, jb)


@pytest.mark.parametrize("layout", ["batched", "single"])
def test_track_memory_encoded_fused_matches_jax(models, layout):
    jm, v, pm = models
    rng = np.random.default_rng(17)
    b, n_q = (2, 3) if layout == "batched" else (1, 7)
    xf = rng.normal(size=(b, 31, 31, CHANNELS)).astype(np.float32)
    zf = rng.normal(size=(b, 7, 7, CHANNELS)).astype(np.float32)
    mem = rng.normal(size=(b * n_q, 7, 7, CHANNELS)).astype(np.float32)
    j_zf = jm.apply(v, jnp.asarray(zf), method=JaxNet.encode_template)
    j_q = jm.apply(v, jnp.asarray(mem), method=JaxNet.encode_memory_kernels)
    if layout == "batched":
        j_q = tuple(q.reshape((b, n_q) + q.shape[1:]) for q in j_q)
    pack = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_fold(v))
    ref = jm.apply(v, jnp.asarray(xf), j_zf, j_q, pack,
                   method=JaxNet.track_memory_encoded_fused)
    with torch.no_grad():
        p_zf = tuple(tuple(_t(t) for t in side) for side in j_zf)
        p_q = tuple(_t(q) for q in j_q)
        out = pm.track_memory_encoded_fused(
            _t(xf), p_zf, p_q, fold_inference_head(pm.connect_model))
        unfused = pm.track_memory_encoded_batched(
            _t(xf), tuple(tuple(t for t in side) for side in p_zf),
            tuple(q if q.dim() == 5 else q[None] for q in p_q))
    for o, r, u in zip(out, ref, unfused):
        _close(o, r)
        _close(o, u.numpy())   # the fold changes f32 rounding only


# ------------------------------------------------------------- ring logic

def _trace(mode, n, rng):
    if mode == "ties":  # quantised: many exact ties
        confs = (rng.integers(0, 4, size=n) / 4.0).astype(np.float32)
    elif mode == "descending":  # the newest frame is always the minimum
        confs = np.linspace(1.0, 0.01, n).astype(np.float32)
    else:
        confs = rng.random(n).astype(np.float32)
    confs[0] = 0.9
    return confs


def _jax_ring_trace(confs, max_frames, n_queue=7):
    """JAX's ring over a whole trace in one lax.scan: (picks, write
    slot) before each frame's write."""
    def step(carry, conf):
        mem_conf, mem_idx, mem_len = carry
        picks = jax_engine._queue_picks(mem_conf, mem_idx, mem_len, n_queue)
        slot = jax_engine._write_slot(mem_conf, mem_idx, mem_len,
                                      max_frames)
        mem_conf = mem_conf.at[slot].set(conf)
        mem_idx = mem_idx.at[slot].set(mem_len)
        return (mem_conf, mem_idx, mem_len + 1), (picks, slot)

    carry = (jnp.zeros((max_frames,)).at[0].set(confs[0]),
             jnp.full((max_frames,), -1, jnp.int32).at[0].set(0),
             jnp.asarray(1, jnp.int32))
    _, (picks, slots) = jax.lax.scan(step, carry, jnp.asarray(confs[1:]))
    return np.asarray(picks), np.asarray(slots)


@pytest.mark.parametrize("mode,n,max_frames", [
    ("ties", 2500, 16), ("random", 2000, 64), ("descending", 2000, 16)])
def test_ring_picks_exact_over_long_traces(mode, n, max_frames):
    """Queue picks and write slots of every frame equal JAX's, through
    thousands of evictions; the port's ring runs the same trace frame by
    frame through `_memory_write_multi` (one identity-coded ring)."""
    confs = _trace(mode, n, np.random.default_rng(21))
    want_picks, want_slots = _jax_ring_trace(confs, max_frames)
    ring = torch.zeros((max_frames + 1, 1, 1, 1))
    mem_conf = torch.zeros(max_frames)
    mem_conf[0] = float(confs[0])
    mem_idx = torch.full((max_frames,), -1, dtype=torch.int32)
    mem_idx[0] = 0
    mem_len = torch.ones((), dtype=torch.int32)
    picks, slots = [], []
    for t in range(1, n):
        picks.append(engine._queue_picks(mem_conf, mem_idx, mem_len, 7))
        slots.append(engine._write_slot(mem_conf, mem_idx, mem_len,
                                        max_frames))
        (ring,), mem_conf, mem_idx, mem_len = engine._memory_write_multi(
            (ring,), mem_conf, mem_idx, mem_len,
            (torch.full((1, 1, 1, 1), float(t)),),
            torch.tensor(confs[t]), torch.tensor(True))
    np.testing.assert_array_equal(torch.stack(picks).numpy(), want_picks)
    np.testing.assert_array_equal(torch.stack(slots).numpy(), want_slots)
    assert int(mem_len) == n
    # each live slot holds the frame its index names
    live = mem_idx.numpy() > 0
    np.testing.assert_array_equal(ring[:max_frames, 0, 0, 0].numpy()[live],
                                  mem_idx.numpy()[live])


@pytest.mark.parametrize("regime", ["shared", "diverged"])
def test_batched_memory_write_exact(regime):
    """`_memory_write_multi_batched` against JAX's (block write or
    scatter) on the same sequence: every real slot and the bookkeeping
    equal, with invalid lanes throughout and T > S so rings evict."""
    rng = np.random.default_rng(11)
    b, s, n_steps, c = 4, 6, 16, 8
    scales = ((5, 5), (3, 5), (5, 3))
    rings0 = [rng.normal(size=(b, s + 1, h, w, c)).astype(np.float32)
              for h, w in scales]
    feats0 = [rng.normal(size=(b, 1, h, w, c)).astype(np.float32)
              for h, w in scales]
    lens = [0, 1, 2, 3] if regime == "diverged" else [0] * b
    j_state = (tuple(jnp.asarray(r) for r in rings0), jnp.zeros((b, s)),
               jnp.full((b, s), -1, jnp.int32),
               jnp.asarray(lens, jnp.int32))
    p_state = (tuple(_t(r) for r in rings0), torch.zeros((b, s)),
               torch.full((b, s), -1, dtype=torch.int32),
               torch.tensor(lens, dtype=torch.int32))
    write = jax.jit(jax_engine._memory_write_multi_batched)
    for t in range(n_steps):
        feats = [f + t for f in feats0]
        score = rng.random(b).astype(np.float32)
        valid = np.ones(b, bool) if regime == "shared" and t < 4 \
            else rng.integers(0, 2, b).astype(bool)
        j_state = write(*j_state, tuple(jnp.asarray(f) for f in feats),
                        jnp.asarray(score), jnp.asarray(valid))
        p_state = engine._memory_write_multi_batched(
            *p_state, tuple(_t(f) for f in feats), _t(score), _t(valid))
        for jr, pr in zip(j_state[0], p_state[0]):
            # the scratch slot S holds garbage by design
            np.testing.assert_array_equal(pr[:, :s].numpy(),
                                          np.asarray(jr)[:, :s])
        for jx, px in zip(j_state[1:], p_state[1:]):
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx))


def test_postprocess_matches_jax():
    p, jp = _config(TrackerConfig), _config(JaxConfig)
    c, jc = engine.make_consts(p, "cpu"), jax_engine.make_consts(jp)
    s, n = p.score_size, 25
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:s, 0:s]
    centres = rng.integers(3, s - 3, (n, 2))
    bump = 3.0 * np.exp(-((yy - centres[:, 0, None, None]) ** 2
                          + (xx - centres[:, 1, None, None]) ** 2) / 8.0)
    cls = (0.3 * rng.normal(size=(n, s, s)) + bump)[..., None]
    cls_mem = (0.3 * rng.normal(size=(n, s, s)) + bump)[..., None]
    bbox = rng.uniform(8.0, 60.0, (n, s, s, 4))
    pos = rng.uniform(100, 400, (n, 2))
    sz = rng.uniform(30, 120, (n, 2))
    scale_z = p.exemplar_size / np.sqrt(np.prod(sz + 0.5 * sz.sum(1)[:, None],
                                                axis=1))
    args = [a.astype(np.float32) for a in (pos, sz, scale_z, cls, bbox,
                                           cls_mem)]
    want = jax.jit(jax.vmap(lambda *a: jax_engine._postprocess_traced(
        jp, jc, a[0], a[1], a[2], a[3][None], a[4][None], a[5][None])))(
        *[jnp.asarray(a) for a in args])
    got = engine._postprocess_traced(p, c, *[_t(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


# --------------------------------------------------------- whole engines

@pytest.fixture(scope="module")
def fixture_models():
    """JAX and port runners on the trained fixture; both packages' engine
    init crops go through the port's OpenCV-free `get_subwindow` (the one
    intended host-crop difference is covered in
    test_torch_port_tracker.py)."""
    kw, v = load_fixture()
    jm = jax_build(**kw)
    pm = build_usot(fused_xcorr=True, **kw)
    runner = ModelRunner(pm, state_dict_from_flax(v), device="cpu")
    return jm, v, JaxRunner(jm, v), pm, runner


FRAMES = 21
BOX = np.array([48.0, 48.0])


def _video():
    frames, centers = synthetic_video(n_frames=FRAMES)
    return frames, np.array(centers[0], np.float64)


@pytest.fixture(scope="module")
def jax_scan(fixture_models):
    """JAX ScanEngine on 20 frames, folded and unfolded head."""
    jm, v, jr, _, _ = fixture_models
    frames, pos = _video()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        for fused in (False, True):
            eng = jax_engine.ScanEngine(jm, v, _config(JaxConfig), 320, 320,
                                        max_frames=8, chunk=8,
                                        fused_head=fused)
            st = eng.init_state(frames[0], pos, BOX, jr)
            out[fused] = eng.track_frames(st, np.stack(frames[1:]))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_scan_engine_matches_jax(fixture_models, jax_scan, fused):
    _, _, _, pm, runner = fixture_models
    frames, pos0 = _video()
    j_st, j_pos, j_sz, j_score = jax_scan[fused]
    eng = engine.ScanEngine(pm, _config(TrackerConfig), 320, 320,
                            max_frames=8, chunk=8, fused_head=fused,
                            device="cpu")
    st = eng.init_state(frames[0], pos0, BOX, runner)
    st, pos, sz, score = eng.track_frames(st, np.stack(frames[1:]))
    assert pos.shape == (FRAMES - 1, 2) and score.shape == (FRAMES - 1,)
    assert np.linalg.norm(pos - j_pos, axis=1).max() <= 0.5
    np.testing.assert_allclose(sz, j_sz, atol=0.5, rtol=0)
    np.testing.assert_allclose(score, j_score, atol=6e-5, rtol=0)
    np.testing.assert_array_equal(st.mem_idx.numpy(), np.asarray(j_st.mem_idx))
    assert int(st.mem_len) == int(j_st.mem_len) == FRAMES
    np.testing.assert_allclose(st.mem_conf.numpy(), np.asarray(j_st.mem_conf),
                               atol=6e-5, rtol=0)


def test_init_host_matches_jax_own_crop(fixture_models):
    """The host part of engine init, JAX's on its own OpenCV crop: the
    template and bootstrap crops within one grey level (mean below 0.25),
    the pool labels and geometry equal."""
    jm, v, _, pm, _ = fixture_models
    frames, pos0 = _video()
    want = jax_engine.ScanEngine(jm, v, _config(JaxConfig), 320, 320,
                                 max_frames=8)._init_host(frames[0], pos0, BOX)
    got = engine.ScanEngine(pm, _config(TrackerConfig), 320, 320,
                            max_frames=8, device="cpu")._init_host(
        frames[0], pos0, BOX)
    assert set(got) == set(want)
    for k in ("z_crop", "x_crop", "x_aug"):
        gap = np.abs(got[k] - want[k])
        assert got[k].shape == want[k].shape, k
        assert gap.max() <= 1.0 and gap.mean() < 0.25, (k, gap.max())
    for k in ("pos", "sz", "avg", "tb", "sb0", "sb1"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _to_port(state):
    return engine.EngineState(*jax.tree.map(lambda a: _t(np.asarray(a)),
                                            tuple(state)))


def test_scan_engine_step_matches_jax(fixture_models):
    """Teacher-forced: before every frame the port's carry is set to
    JAX's, so each step starts from the same state. The frame's position
    agrees within 0.01 px and its score within 5e-5: measured, 18 of the
    20 steps agree within 1e-5 and the largest gap is 3.3e-5 (frame 9),
    the backbones' f32 gap (~1.3e-5 relative on the search features)
    carried through the heads."""
    jm, v, jr, pm, runner = fixture_models
    frames, pos0 = _video()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        j_eng = jax_engine.ScanEngine(jm, v, _config(JaxConfig), 320, 320,
                                      max_frames=8, chunk=1, fused_head=True)
        j_st = j_eng.init_state(frames[0], pos0, BOX, jr)
    eng = engine.ScanEngine(pm, _config(TrackerConfig), 320, 320,
                            max_frames=8, chunk=1, fused_head=True,
                            device="cpu")
    eng.init_state(frames[0], pos0, BOX, runner)
    # JAX donates the carry to each chunk: convert it before the next one
    carry = _to_port(j_st)
    steps = j_eng.iter_chunks(j_st, np.stack(frames[1:]))
    for t, (_, _, j_next, j_out) in enumerate(steps, start=1):
        _, out = eng.run_chunk(carry, _t(frames[t][None]),
                               torch.ones(1, dtype=torch.bool))
        np.testing.assert_allclose(out[2].numpy(), np.asarray(j_out[2]),
                                   atol=5e-5, rtol=0, err_msg=f"frame {t}")
        np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out[0]),
                                   atol=1e-2, rtol=0, err_msg=f"frame {t}")
        carry = _to_port(j_next)


def test_batch_engine_matches_jax(fixture_models):
    """B=3 lanes on one video with ragged lengths against JAX's native
    batched engine; finished lanes freeze exactly."""
    jm, v, jr, pm, runner = fixture_models
    frames, pos0 = _video()
    videos = [(frames[0], pos0, BOX)] * 3
    stack = np.stack([np.stack(frames[1:])] * 3)
    n_valid = np.array([20, 13, 7])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        j_eng = jax_engine.BatchScanEngine(
            jm, v, _config(JaxConfig), 320, 320, batch=3, max_frames=8,
            chunk=8, impl="native")
        j_st, j_pos, j_sz, j_score = j_eng.track_batch(
            j_eng.init_batch(videos, jr), stack, n_valid)
    eng = engine.BatchScanEngine(pm, _config(TrackerConfig), 320, 320,
                                 batch=3, max_frames=8, chunk=8,
                                 device="cpu")
    st, pos, sz, score = eng.track_batch(eng.init_batch(videos, runner),
                                         stack, n_valid)
    for lane, n in enumerate(n_valid):
        assert np.linalg.norm(pos[lane, :n] - j_pos[lane, :n],
                              axis=1).max() <= 0.5
        np.testing.assert_allclose(sz[lane, :n], j_sz[lane, :n], atol=0.5)
        np.testing.assert_allclose(score[lane, :n], j_score[lane, :n],
                                   atol=6e-5, rtol=0)
        np.testing.assert_array_equal(st.pos[lane].numpy(), pos[lane, n - 1])
        np.testing.assert_array_equal(st.sz[lane].numpy(), sz[lane, n - 1])
    np.testing.assert_array_equal(st.mem_idx.numpy(), np.asarray(j_st.mem_idx))
    np.testing.assert_allclose(st.mem_conf.numpy(), np.asarray(j_st.mem_conf),
                               atol=6e-5, rtol=0)
    np.testing.assert_array_equal(st.mem_len.numpy(), n_valid + 1)
    np.testing.assert_array_equal(np.asarray(j_st.mem_len), n_valid + 1)


def test_batch_engine_lane_matches_scan_engine(fixture_models):
    """Two identical lanes of the batch engine track exactly as the scan
    engine does: the same batched step at B=2 and B=1."""
    _, _, _, pm, runner = fixture_models
    frames, pos0 = _video()
    frames = frames[:7]
    p = _config(TrackerConfig)
    single = engine.ScanEngine(pm, p, 320, 320, max_frames=8, chunk=4,
                               device="cpu")
    _, pos_s, sz_s, _ = single.track_frames(
        single.init_state(frames[0], pos0, BOX, runner),
        np.stack(frames[1:]))
    batch = engine.BatchScanEngine(pm, p, 320, 320, batch=2, max_frames=8,
                                   chunk=4, device="cpu")
    _, pos_b, sz_b, _ = batch.track_batch(
        batch.init_batch([(frames[0], pos0, BOX)] * 2, runner),
        np.stack([np.stack(frames[1:])] * 2), np.array([6, 6]))
    for lane in range(2):
        np.testing.assert_allclose(pos_b[lane], pos_s, atol=1e-3)
        np.testing.assert_allclose(sz_b[lane], sz_s, atol=1e-3)


def test_synthetic_video_is_the_bench_recipe():
    import bench

    ours = engine.synthetic_video(70, h=300, w=320, box=20, seed=3)
    ref = bench.synthetic_video(70, h=300, w=320, box=20, seed=3)
    assert len(ours) == len(ref) == 70
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
