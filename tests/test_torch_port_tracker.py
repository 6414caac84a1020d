"""Port tracker (`usot_tpu_torch.tracker`, `core.crop`) against `usot_tpu`.

* The OpenCV-free crop against `usot_tpu.core.crop.get_subwindow`
  (cv2.resize): at most one grey level on every pixel, mean below 0.25.
* The full USOT* tracker loop on the committed trained fixture, with both
  trackers fed the same crop pixels: per-frame positions and sizes within
  0.5 px and memory confidences within 1e-5 (`PARITY.md:86-87`).
"""
import numpy as np
import pytest
import torch

import usot_tpu.tracker.tracker as jax_tracker_mod
from usot_tpu.core.crop import get_subwindow as cv2_subwindow
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu.tracker.runner import ModelRunner as JaxRunner
from usot_tpu.tracker.tracker import USOTTracker as JaxTracker
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.tracker.runner import ModelRunner
from usot_tpu_torch.tracker.tracker import USOTTracker

from test_tracker import synthetic_video
from torch_port_common import load_fixture

# Several test workers share the host's cores; tiny shapes need few threads.
torch.set_num_threads(2)


def test_crop_matches_cv2():
    rng = np.random.default_rng(0)
    diffs = []
    for _ in range(40):
        h, w = rng.integers(40, 240, size=2)
        im = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        pos = rng.uniform(-20, [w + 20, h + 20])
        original_sz = int(rng.integers(16, 320))
        model_sz = int(rng.choice([127, 255, 271]))
        avg = im.mean(axis=(0, 1))
        tsz = rng.uniform(8, 64, size=2)
        ours, info = get_subwindow(im, pos, model_sz, original_sz, avg, tsz,
                                   need_bbox=True)
        ref, ref_info = cv2_subwindow(im, pos, model_sz, original_sz, avg,
                                      tsz, need_bbox=True)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        assert info == ref_info
        diffs.append(np.abs(ours.astype(int) - ref.astype(int)).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 1
    assert diffs.mean() < 0.25


def test_crop_without_resize_is_exact():
    rng = np.random.default_rng(1)
    im = rng.integers(0, 256, size=(90, 70, 3), dtype=np.uint8)
    avg = im.mean(axis=(0, 1))
    ours, _ = get_subwindow(im, [60.0, 10.0], 127, 127, avg)
    ref, _ = cv2_subwindow(im, [60.0, 10.0], 127, 127, avg)
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def runners():
    kw, v = load_fixture()
    jax_runner = JaxRunner(jax_build(**kw), v)
    port_runner = ModelRunner(build_usot(fused_xcorr=True, **kw),
                              state_dict_from_flax(v), device="cpu")
    return jax_runner, port_runner


def _run(tracker, runner, frames, pos, sz):
    st = tracker.init(frames[0], pos, sz, runner)
    out = []
    for im in frames[1:]:
        st = tracker.track(st, im)
        out.append((np.array(st["target_pos"]), np.array(st["target_sz"])))
    return st, out


@pytest.mark.parametrize("size,box", [(320, 48), (640, 16)])
def test_tracker_matches_jax(runners, monkeypatch, size, box):
    """Both trackers crop with the port's get_subwindow (the one intended
    difference, cv2 fixed point vs float bilinear, is covered above), so
    the rest of the loop must agree: network, postprocess, queue
    sampling and memory write."""
    monkeypatch.setattr(jax_tracker_mod, "get_subwindow", get_subwindow)
    jax_runner, port_runner = runners
    n_frames = 11 if box == 48 else 5
    frames, centers = synthetic_video(n_frames=n_frames, size=size, box=box)
    pos = np.array(centers[0], np.float64)
    sz = np.array([box, box], np.float64)
    j_st, j_traj = _run(JaxTracker(), jax_runner, frames, pos, sz)
    p_st, p_traj = _run(USOTTracker(), port_runner, frames, pos, sz)

    assert p_st["p"].instance_size == (255 if box == 48 else 271)
    assert p_st["p"].instance_size == j_st["p"].instance_size
    for (jp, js), (pp, ps) in zip(j_traj, p_traj):
        assert np.linalg.norm(pp - jp) <= 0.5, (j_traj, p_traj)
        np.testing.assert_allclose(ps, js, atol=0.5)
    np.testing.assert_allclose(p_st["memory_confidences"],
                               j_st["memory_confidences"], atol=1e-5, rtol=0)
    assert len(p_st["memory_features"]) == n_frames
    feats = [f.numpy() for f in p_st["memory_features"]]
    ref = [np.asarray(f) for f in j_st["memory_features"]]
    scale = max(np.abs(np.stack(ref)).max(), 1.0)
    np.testing.assert_allclose(np.stack(feats), np.stack(ref),
                               atol=1e-4 * scale, rtol=0)


def test_fixture_port_follows_target(runners):
    """The port tracker follows the synthetic target with the trained
    fixture (the parity above is only meaningful on a peaked map)."""
    _, port_runner = runners
    frames, centers = synthetic_video(n_frames=13)
    tracker = USOTTracker()
    st = tracker.init(frames[0], np.array(centers[0], np.float64),
                      np.array([48.0, 48.0]), port_runner)
    errs = []
    for f, im in enumerate(frames[1:], start=1):
        st = tracker.track(st, im)
        errs.append(np.linalg.norm(st["target_pos"] - np.asarray(centers[f])))
    assert np.mean(errs) < 24.0, errs
    assert all(t.device.type == "cpu" for t in st["memory_features"])


def test_memory_queue_assembly(runners):
    _, port_runner = runners
    frames, centers = synthetic_video(n_frames=2)
    tracker = USOTTracker()
    st = tracker.init(frames[0], np.array(centers[0], np.float64),
                      np.array([48.0, 48.0]), port_runner)
    p = st["p"]
    mem, scores = tracker._assemble_memory_queue(st, p)
    assert isinstance(mem, torch.Tensor)
    assert mem.shape[0] == p.mem_queue_size == len(scores)
    st["memory_features"] = st["memory_features"] * 9
    st["memory_confidences"] = list(np.linspace(0.1, 0.9, 9))
    mem, scores = tracker._assemble_memory_queue(st, p)
    assert mem.shape[0] == p.mem_queue_size == len(scores)


def test_runner_batched_and_encoded_calls(runners):
    """The runner's `*_batch` and `encode_*` entry points agree with the
    single-image calls and with the model's methods."""
    _, runner = runners
    rng = np.random.default_rng(4)
    z = (rng.random((2, 127, 127, 3)) * 255).astype(np.float32)
    x = (rng.random((2, 255, 255, 3)) * 255).astype(np.float32)
    tb = np.array([[3.0, 3.0, 11.0, 11.0], [2.0, 4.0, 12.0, 10.0]],
                  np.float32)
    sb = np.array([[5.0, 6.0, 20.0, 19.0], [1.0, 2.0, 24.0, 23.0]],
                  np.float32)
    zf = runner.template_batch(z, tb)
    mem = runner.extract_memory_feature_batch(x, sb)
    def close(a, b):  # batch 2 vs batch 1: other conv summation orders
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))

    for i in range(2):
        close(zf[i:i + 1], runner.template(z[i], tb[i]))
        close(mem[i:i + 1], runner.extract_memory_feature(x_hwc=x[i],
                                                          search_bbox=sb[i]))
    cls_z, reg_z = runner.encode_template(zf[:1])
    queue = runner.encode_memory_kernels(mem)
    assert [tuple(t.shape[1:3]) for t in cls_z] == [(5, 5), (3, 5), (5, 3)]
    assert len(reg_z) == 3 and queue[0].shape[0] == 2
    xf = runner.search_features(x[0])
    cls, bbox = runner.track_offline(xf, zf[:1])
    with torch.inference_mode():
        enc = runner.model.track_memory_encoded(xf, (cls_z, reg_z), queue)
    np.testing.assert_allclose(
        cls, torch.sigmoid(enc[0][0, :, :, 0]).double().numpy(), atol=1e-6)
    np.testing.assert_allclose(
        bbox, enc[1][0].permute(2, 0, 1).double().numpy(), rtol=1e-5,
        atol=1e-5)
