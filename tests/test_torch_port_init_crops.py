"""The batch engine's init crops on the device (`core.crop.crop_windows`
through `BatchScanEngine._init_device`) against the host crops of
`_init_host` (`get_subwindow`, `np.mean`): bitwise on the CPU, within one
grey level on the card.

Window placements: inside the frame, across each of the four edges,
larger than the frame, unresized (a window whose side is the model's),
and non-square frames, each lane beside a lane of another frame size on
one canvas. Then the engine: `init_batch` and `make_lane_states` on the
device crops give bitwise the state of the host-crop path (`_init_lanes`
fed `_init_host`'s crops), and `init_lanes_device` counts the lanes.

This file imports no JAX: on a machine with a card it runs as
`python -m pytest --noconftest tests/test_torch_port_init_crops.py`
(the test marked `gpu` skips without one).
"""
import os

import numpy as np
import pytest
import torch

from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.engine import BatchScanEngine, EngineState
from usot_tpu_torch.tracker.runner import ModelRunner

torch.set_num_threads(2)
CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_usot_w8c32.msgpack")

# (frame h, w), target centre (x, y), target size (w, h)
PLACEMENTS = {
    "inside": ((480, 640), (300.0, 200.0), (40.0, 30.0)),
    "left_edge": ((240, 320), (6.0, 120.0), (40.0, 30.0)),
    "right_edge": ((240, 320), (315.3, 100.0), (50.0, 40.0)),
    "top_edge": ((240, 320), (160.0, 3.5), (30.0, 30.0)),
    "bottom_edge": ((240, 320), (150.0, 236.7), (44.0, 28.0)),
    "larger_than_frame": ((120, 160), (80.0, 60.0), (150.0, 110.0)),
    "unresized": ((300, 300), (150.0, 150.0), (63.5, 63.5)),
    "tall_frame": ((300, 90), (45.0, 150.0), (20.0, 60.0)),
    "wide_frame": ((64, 400), (390.0, 30.0), (36.0, 24.0)),
}
# the other lane of each batch: another frame size, its window inside
OTHER = ((180, 260), (130.0, 90.0), (24.0, 20.0))


def _model():
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.train.checkpoint import load_model_state
    from usot_tpu_torch.utils.msgpack import read_msgpack

    meta = read_msgpack(FIXTURE)
    model = build_usot(mem_size=int(meta["mem_size"]),
                       width=int(meta["width"]),
                       channels=int(meta["channels"]))
    model.load_state_dict(load_model_state(FIXTURE))
    return model


@pytest.fixture(scope="module")
def model():
    return _model()


def _engine(model, batch, device=CPU):
    return BatchScanEngine(model, TrackerConfig(), 400, 400, batch=batch,
                           max_frames=8, chunk=2, device=device)


def _lane(rng, frame_hw, pos, sz):
    im = rng.integers(0, 256, frame_hw + (3,), dtype=np.uint8)
    return im, np.array(pos), np.array(sz)


def _stack_hosts(hosts):
    """`_init_host`'s per-lane dicts as the stacked pieces `_init_lanes`
    takes: the host-crop path."""
    return dict(
        pos=np.stack([h["pos"] for h in hosts]),
        sz=np.stack([h["sz"] for h in hosts]),
        avg=np.stack([h["avg"] for h in hosts]),
        z=np.stack([h["z_crop"] for h in hosts]),
        tb=np.stack([h["tb"] for h in hosts]),
        xs=np.stack([h[k] for h in hosts for k in ("x_crop", "x_aug")]),
        sbs=np.stack([h[k] for h in hosts for k in ("sb0", "sb1")]))


def _assert_same_pieces(got, want, grey=0.0):
    """Device pieces against the host's: crops within `grey` levels
    (bitwise at 0), everything else bitwise."""
    for k in ("z", "xs"):
        gap = np.abs(got[k].cpu().numpy() - want[k])
        assert gap.max() <= grey, (k, gap.max())
    np.testing.assert_array_equal(got["avg"].cpu().numpy(), want["avg"])
    for k in ("pos", "sz", "tb", "sbs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_device_crops_are_the_host_crops(model, placement):
    """Both lanes' 127 template, 255 bootstrap crop and its flip bitwise
    `get_subwindow`'s, the mean colour bitwise `np.mean`'s (the uint8 pad
    truncates it), and the same labels, on a canvas of two frame sizes."""
    rng = np.random.default_rng(sorted(PLACEMENTS).index(placement))
    lanes = [_lane(rng, *PLACEMENTS[placement]), _lane(rng, *OTHER)]
    eng = _engine(model, 2)
    got = eng._init_device(lanes)
    want = _stack_hosts([eng._init_host(*v) for v in lanes])
    assert got["z"].shape == (2, 127, 127, 3)
    assert got["xs"].shape == (4, 255, 255, 3)
    assert got["avg"].dtype == torch.float64
    _assert_same_pieces(got, want)
    np.testing.assert_array_equal(got["xs"][1::2].numpy(),
                                  got["xs"][0::2].flip(2).numpy())


def test_crop_windows_fill_the_pad_with_the_truncated_mean(model):
    """A window wholly outside a dark frame with one bright pixel: every
    pixel of the crop is the truncated mean colour."""
    from usot_tpu_torch.core.crop import crop_windows, get_subwindow

    im = np.zeros((50, 60, 3), np.uint8)
    im[0, 0] = (255, 200, 131)
    avg = np.mean(im, axis=(0, 1))
    want, _ = get_subwindow(im, [300.0, 300.0], 31, 40, avg)
    fill = torch.as_tensor(avg).to(torch.uint8).float()[None]
    got = crop_windows(torch.from_numpy(im)[None], [(50, 60)], fill,
                       [(280, 280, 40)], 31)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert np.unique(want.reshape(-1, 3), axis=0).tolist() == [
        [int(a) for a in avg]]


def _state_equal(a: EngineState, b: EngineState):
    for x, y in zip(torch.utils._pytree.tree_leaves(tuple(a)),
                    torch.utils._pytree.tree_leaves(tuple(b))):
        assert torch.equal(x, y)


def test_init_batch_on_device_crops_is_the_host_path(model):
    """`init_batch` (device crops) against `_init_lanes` fed the lanes'
    `_init_host` crops: the same carry, avg and image-size rows, bitwise;
    `init_lanes_device` counts B lanes a call and nothing for the
    single-video `init_state`."""
    rng = np.random.default_rng(11)
    lanes = [_lane(rng, *PLACEMENTS[k]) for k in
             ("inside", "right_edge", "larger_than_frame")]
    runner = ModelRunner(model, device="cpu")
    eng = _engine(model, 3)
    assert eng.init_lanes_device == 0
    got = eng.init_batch(lanes, runner)
    assert eng.init_lanes_device == 3
    avg, hw = eng._avg_b.clone(), eng._im_hw_b.clone()
    ref = _engine(model, 3)
    want = ref._init_lanes(
        _stack_hosts([ref._init_host(*v) for v in lanes]),
        [list(v[0].shape[:2]) for v in lanes], runner)
    _state_equal(got, want)
    assert torch.equal(avg, ref._avg_b) and torch.equal(hw, ref._im_hw_b)
    np.testing.assert_array_equal(
        avg.numpy(), np.stack([np.mean(v[0], axis=(0, 1))
                               for v in lanes]).astype(np.float32))
    assert ref._init_span == eng._init_span
    eng.init_batch(lanes, runner)
    assert eng.init_lanes_device == 6
    single = _engine(model, 1)
    single.init_state(*lanes[0], runner)
    assert single.init_lanes_device == 0 and ref.init_lanes_device == 0


def test_make_lane_states_on_device_crops_is_the_host_path(model):
    """`make_lane_states` for K = 2 of B = 3 lanes against the host crops
    padded with lane 0 through the same batched passes: every piece
    bitwise; `init_lanes_device` counts the K lanes."""
    rng = np.random.default_rng(12)
    lanes = [_lane(rng, *PLACEMENTS[k]) for k in ("top_edge", "wide_frame")]
    runner = ModelRunner(model, device="cpu")
    eng = _engine(model, 3)
    got = eng.make_lane_states(lanes, runner)
    assert eng.init_lanes_device == 2
    hosts = [eng._init_host(*v) for v in lanes]
    want = _stack_hosts(hosts + hosts[:1])
    zf_enc, feat_enc = eng._encode(want, runner)
    assert got["k"] == 2
    np.testing.assert_array_equal(got["pos"], want["pos"].astype(np.float32))
    np.testing.assert_array_equal(got["sz"], want["sz"].astype(np.float32))
    np.testing.assert_array_equal(got["avg"].numpy(),
                                  want["avg"].astype(np.float32))
    np.testing.assert_array_equal(
        got["im_hw"], [[240, 320], [64, 400], [240, 320]])
    for x, y in zip(torch.utils._pytree.tree_leaves((got["zf_enc"],
                                                      got["feat_enc"])),
                    torch.utils._pytree.tree_leaves((zf_enc, feat_enc))):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_device_crops_on_gpu():
    """On the card, 64 lanes of 480x640 with windows inside and across
    the edges: crops within one grey level of `get_subwindow` (CUDA's
    bilinear rounds differently in the last bit), the mean colour bitwise
    `np.mean`'s, labels equal. Prints the share of crop values that
    differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    rng = np.random.default_rng(17)
    lanes = []
    for _ in range(64):
        pos = rng.uniform([0, 0], [640, 480])
        lanes.append(_lane(rng, (480, 640), tuple(pos),
                           tuple(rng.uniform(12, 200, 2))))
    eng = _engine(_model(), 64, cuda)
    got = eng._init_device(lanes)
    want = _stack_hosts([eng._init_host(*v) for v in lanes])
    _assert_same_pieces(got, want, grey=1.0)
    differ = [float((got[k].cpu().numpy() != want[k]).mean())
              for k in ("z", "xs")]
    print(f"crop values that differ from the host's: template "
          f"{differ[0]:.3e}, bootstrap and flip {differ[1]:.3e}")
