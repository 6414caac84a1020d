"""The port's engines in bfloat16 against `usot_tpu`'s, on the CPU.

The trained w8c32 fixture in both packages, 20 frames of the 48-px
synthetic video (`tests/test_tracker.py`), JAX's engines on the port's
OpenCV-free host crop (as `test_torch_port_engine.py`). No bfloat16
trajectory can be held to another at 0.5 px (the two packages round at
different places, and XLA keeps excess precision inside a fusion), so
the limits are relative to JAX's own bfloat16-vs-float32 gap, computed
in the test:

* `ScanEngine` and `BatchScanEngine` (B=2): the port's trajectory
  deviates from JAX's bfloat16 trajectory, in mean and in max, by no
  more than JAX's bfloat16 deviates from its float32 one; its error
  against the ground truth is within 25 % of JAX's bfloat16 error; the
  rings, the init anchors and the template are carried in bfloat16;
* one teacher-forced step per frame (the port and JAX's float32 engine
  fed JAX's bfloat16 carry): the port's largest position and score gaps
  to JAX's bfloat16 step at most JAX's own float32-vs-bfloat16 ones.
Measured: port vs JAX bfloat16 mean 2.70, max 7.34 px, against JAX's own
3.79 and 8.08 px; error against the ground truth 11.83 px (JAX bfloat16
12.10, float32 14.01).
"""
import jax
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
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.tracker import engine
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.runner import ModelRunner

from test_tracker import synthetic_video
from torch_port_common import load_fixture

torch.set_num_threads(2)
BF16 = torch.bfloat16


FRAMES = 21
BOX = np.array([48.0, 48.0])


def _config(cls):
    p = cls()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def _video():
    frames, centers = synthetic_video(n_frames=FRAMES)
    return frames, np.array(centers, np.float64)


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


def _to_port(state):
    return engine.EngineState(*jax.tree.map(_t, tuple(state)))


@pytest.fixture(scope="module")
def fixture_engines():
    """JAX's ScanEngine (one-frame chunks) on the fixture in float32 and
    in bfloat16, each tracking the video once; both also serve the
    teacher-forced steps."""
    kw, v = load_fixture()
    frames, centers = _video()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        for tag, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            jm = jax_build(dtype=dt, **kw)
            runner = JaxRunner(jm, v)
            eng = jax_engine.ScanEngine(jm, v, _config(JaxConfig), 320, 320,
                                        max_frames=8, chunk=1)
            out[tag] = dict(engine=eng, track=eng.track_frames(
                eng.init_state(frames[0], centers[0], BOX, runner),
                np.stack(frames[1:])))
            if tag == "bf16":
                out[tag]["init"] = eng.init_state(frames[0], centers[0], BOX,
                                                  runner)
    return v, out


def _deviation(a, b):
    d = np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)
    return d.mean(), d.max()


def _port_engine(v, batch=None):
    kw, _ = load_fixture()
    pm = build_usot(fused_xcorr=True, dtype=BF16, **kw)
    runner = ModelRunner(pm, state_dict_from_flax(v), device="cpu")
    if batch is None:
        eng = engine.ScanEngine(pm, _config(TrackerConfig), 320, 320,
                                max_frames=8, chunk=8, device="cpu")
    else:
        eng = engine.BatchScanEngine(pm, _config(TrackerConfig), 320, 320,
                                     batch=batch, max_frames=8, chunk=8,
                                     device="cpu")
    return eng, runner


def _hold_track(pos, jax_runs):
    """The criterion of the module note on one trajectory (N, 2)."""
    _, centers = _video()
    gt = centers[1:]
    j_bf, j_f32 = jax_runs["bf16"]["track"][1], jax_runs["f32"]["track"][1]
    own_mean, own_max = _deviation(j_bf, j_f32)
    mean, worst = _deviation(pos, j_bf)
    err, j_err = _deviation(pos, gt)[0], _deviation(j_bf, gt)[0]
    print(f"port vs JAX bf16: mean {mean:.2f} max {worst:.2f} px; JAX bf16 "
          f"vs f32: mean {own_mean:.2f} max {own_max:.2f}; error vs ground "
          f"truth: port {err:.2f}, JAX bf16 {j_err:.2f}, JAX f32 "
          f"{_deviation(j_f32, gt)[0]:.2f} px")
    assert mean <= own_mean and worst <= own_max
    assert err <= 1.25 * j_err


def test_scan_engine_bf16_tracks_as_jax(fixture_engines):
    v, jax_runs = fixture_engines
    frames, centers = _video()
    eng, runner = _port_engine(v)
    st = eng.init_state(frames[0], centers[0], BOX, runner)
    assert all(r.dtype == BF16 for r in st.mem_enc + st.init_enc)
    st, pos, sz, score = eng.track_frames(st, np.stack(frames[1:]))
    assert all(r.dtype == BF16 for r in st.mem_enc)
    assert np.all(np.isfinite(pos)) and np.all(np.isfinite(score))
    assert int(st.mem_len) == FRAMES
    _hold_track(pos, jax_runs)


def test_batch_engine_bf16_tracks_as_jax(fixture_engines):
    """B=2, both lanes on the video: each lane held as the scan engine."""
    v, jax_runs = fixture_engines
    frames, centers = _video()
    eng, runner = _port_engine(v, batch=2)
    st = eng.init_batch([(frames[0], centers[0], BOX)] * 2, runner)
    st, pos, sz, score = eng.track_batch(
        st, np.stack([np.stack(frames[1:])] * 2), np.array([20, 20]))
    assert all(r.dtype == BF16 for r in st.mem_enc + st.init_enc)
    np.testing.assert_array_equal(st.mem_len.numpy(), [FRAMES, FRAMES])
    for lane in range(2):
        _hold_track(pos[lane], jax_runs)


def test_engine_step_bf16_teacher_forced(fixture_engines):
    """Before every frame the port's bfloat16 engine and JAX's float32
    engine get JAX's bfloat16 carry; the port's step is held against
    JAX's bfloat16 step by JAX's own float32-vs-bfloat16 step gap (max
    over the 20 steps, position and score)."""
    v, jax_runs = fixture_engines
    frames, centers = _video()
    j_bf, j_f32 = jax_runs["bf16"], jax_runs["f32"]
    eng, runner = _port_engine(v)
    eng.init_state(frames[0], centers[0], BOX, runner)
    carry = j_bf["init"]
    gaps = {"port_pos": [], "own_pos": [], "port_score": [], "own_score": []}
    for t in range(1, FRAMES):
        # JAX donates a chunk's carry: copy it before each JAX step
        port_carry = _to_port(carry)
        f32_carry = jax.tree.map(
            lambda a: jnp.array(a, jnp.float32 if a.dtype == jnp.bfloat16
                                else a.dtype, copy=True), carry)
        _, (f_pos, _, f_score) = _jax_step(j_f32["engine"], f32_carry,
                                           frames[t])
        carry, (b_pos, _, b_score) = _jax_step(j_bf["engine"], carry,
                                               frames[t])
        _, out = eng.run_chunk(port_carry, _t(frames[t][None]),
                               torch.ones(1, dtype=torch.bool))
        b_pos, b_score = np.asarray(b_pos)[0], float(b_score[0])
        gaps["port_pos"].append(np.linalg.norm(out[0].numpy()[0] - b_pos))
        gaps["own_pos"].append(np.linalg.norm(np.asarray(f_pos)[0] - b_pos))
        gaps["port_score"].append(abs(float(out[2][0]) - b_score))
        gaps["own_score"].append(abs(float(f_score[0]) - b_score))
    worst = {k: max(g) for k, g in gaps.items()}
    print(f"teacher-forced steps: {worst}")
    assert worst["port_pos"] <= worst["own_pos"]
    assert worst["port_score"] <= worst["own_score"]


def _jax_step(eng, carry, frame):
    """One frame through JAX's one-frame chunk; (carry, outs)."""
    (_, _, nxt, outs), = list(eng.iter_chunks(carry, frame[None]))
    return nxt, outs
