"""The mining cell's plain reference against the port at small sizes on
the CPU (`reference/pwclite.py`, `reference/mining.py`), and the cell's
check against the program with each of `faults.MINING` planted. The
test imports the port; the reference does not."""
import numpy as np
import pytest
import torch

from conftest import small_context
from portbench import faults, harness
from portbench.mine_inputs import flow_weights, make_videos, with_gain
from portbench.reference import mining as ref
from portbench.reference import pwclite as ref_net

CELL = "mine_got10k_720p"
SHAPE = (128, 192)  # sides multiples of 64, as PWCLite's pyramid needs
TRAFFIC = dict(frame=[192, 256], lengths=[16], objects=[2],
               object_frac=[0.2, 0.35], speed_px=[1.0, 6.0],
               pan_px=[0.5, 2.0], content_seed=2 ** 31 + 21)


@pytest.fixture(scope="module")
def video():
    return make_videos(2 ** 31 + 23, TRAFFIC, "cpu")[0][1]


@pytest.fixture(scope="module")
def weights():
    return with_gain(flow_weights(2 ** 31 + 22, "cpu"), 20.0)


@torch.no_grad()
def test_network_matches_port(video, weights):
    """The 3-frame forward at a small test shape (PWCLite's widths are
    fixed in the port, so the input is what is cut): the same
    convolutions in the same order, the cost volume summed by shift
    where the port takes one strided product, the warp by `grid_sample`
    where the port gathers its four neighbours: a few float32 roundings
    apart, within 1e-5 of the flow's largest vector (measured ~1e-6)."""
    from usot_tpu_torch.preprocessing.inference import FlowHelper
    from usot_tpu_torch.preprocessing.pwclite import resize_flow

    helper = FlowHelper(weights, test_shape=SHAPE, device="cpu")
    pre = [helper.preprocess(f[..., ::-1]) for f in video]
    for lo, i, hi in ((0, 4, 8), (3, 6, 9), (5, 6, 7)):
        got = resize_flow(helper.forward(pre, lo, i, hi), 192, 256)
        x = [ref.preprocess(video[j], SHAPE, "cpu") for j in (lo, i, hi)]
        assert torch.equal(torch.stack([p for p in (pre[lo], pre[i],
                                                    pre[hi])]),
                           torch.cat(x))
        f12, _ = ref_net.flows_3_frames(weights, *x)
        want = ref.to_frame(f12, 192, 256)
        scale = float(want.abs().max())
        assert scale > 1.0
        assert float((got - want).abs().max()) < 1e-5 * scale


def test_loop_rule_matches_port():
    from usot_tpu_torch.preprocessing.inference import next_interval

    for m in (0.0, 7.99, 8.0, 12.0, 16.0, 16.01, 40.0):
        for adjacent in range(1, 8):
            for direction in (-1, 0, 1):
                assert ref.next_interval(m, adjacent, direction) == \
                    next_interval(m, adjacent, direction)


def _flows(seed):
    """Flow fields flow_to_bbox sees: one moving block, two blocks, smooth
    noise and a near-still field."""
    rng = np.random.default_rng(seed)
    h, w = 160, 224
    a = rng.normal(0, 0.3, (h, w, 2)).astype(np.float32)
    a[40:100, 60:150] += [6.0, 3.0]
    b = rng.normal(0, 0.2, (h, w, 2)).astype(np.float32)
    b[20:60, 30:90] += [-4.0, 1.0]
    b[110:158, 150:222] += [3.0, 5.0]
    c = torch.nn.functional.avg_pool2d(
        torch.from_numpy(rng.normal(0, 2, (1, 2, h, w)).astype(np.float32)),
        9, 1, 4)[0].permute(1, 2, 0).numpy()
    d = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    return [a, b, c, d]


@pytest.mark.parametrize("seed", [0, 1])
def test_boxes_and_dp_equal_the_port(seed):
    """The reference's copies of flow_to_bbox, the DP and the video's
    statistics give the port's answers exactly on the same flows and the
    same generator."""
    from usot_tpu_torch.preprocessing import flow2box

    flows = _flows(seed) * 6
    cands = [ref.flow_to_bbox(f) for f in flows]
    assert cands == [flow2box.flow_to_bbox(f) for f in flows]
    assert any(cands) and not all(cands)
    length = 3 * len(flows) + 4
    ours = ref.smooth_bbox_dp(cands, length, np.random.RandomState(seed))
    theirs = flow2box.smooth_bbox_dp(cands, length,
                                     rng=np.random.RandomState(seed))
    assert ours == theirs
    assert ref.calc_nearby_bbox_freq(ours[1], length) == \
        flow2box.calc_nearby_bbox_freq(theirs[1], length)
    assert ref.calc_corner_bbox_freq(ours[0], (160, 224)) == \
        flow2box.calc_corner_bbox_freq(theirs[0], (160, 224))


def test_crop_within_a_grey_level_of_the_port(video):
    """The reference's float64 gather against the port's float32
    `warp_affine`: a value half-way between two levels can round either
    way, so one level apart at a few pixels, never two."""
    from usot_tpu_torch.preprocessing.crop_gen import crop_like_siamfc

    frame = video[5]
    for box in ((60.0, 50.0, 130.0, 110.0), (2.5, 3.0, 60.5, 40.0),
                (180.0, 140.0, 250.0, 190.0)):
        _, want = crop_like_siamfc(frame, box, instance_size=127,
                                   padding=np.mean(frame, axis=(0, 1)))
        got = ref.crop_x(torch.from_numpy(frame), box, out=127)
        gap = np.abs(got.numpy().astype(int) - want.astype(int))
        assert gap.max() <= 1 and (gap > 0).mean() < 1e-2


def readings(line):
    return {k: v["value"] for k, v in line["checks"].items()}


@pytest.fixture(scope="module")
def sound():
    bench, ctx = small_context(CELL, seconds=0.0)
    return harness.run_cell(ctx, bench)


def test_sound_run_passes(sound):
    assert sound["correct"]
    r = readings(sound)
    assert r["maxflow_rel"] < 1e-5 and r["decision_flips"] == 0
    assert r["box_px_p90"] == 0 and r["crop_levels_max"] <= 1


@pytest.mark.parametrize("fault", sorted(faults.MINING))
def test_fault_caught(fault, sound, monkeypatch):
    with monkeypatch.context() as m:
        faults.MINING[fault](m)
        bench, ctx = small_context(CELL, seconds=0.0)
        broken = harness.run_cell(ctx, bench)
    assert not broken["correct"]
    s, b = readings(sound), readings(broken)
    assert any(b[k] >= 10 * max(s[k], 1e-12) and b[k] > v["limit"]
               for k, v in broken["checks"].items())


def test_reference_numerics_are_its_own():
    """`numerics.deterministic` sets cuDNN's switches for the block alone
    and gives the caller's back, also when the block raises."""
    from portbench.reference.numerics import deterministic

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        with pytest.raises(RuntimeError):
            with deterministic():
                assert cudnn.deterministic and not cudnn.benchmark
                raise RuntimeError
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def test_an_idle_gap_is_split_among_the_spans_it_spans():
    """A gap that runs from one span through the next and out of both is
    cut at their edges: each span gets its own part of it."""
    from portbench.trace import _attribute

    spans = [(0, 100, "window"), (10, 40, "infer"), (40, 70, "crop")]
    out = _attribute([(20, 90)], spans)
    assert out == pytest.approx({"infer": 20e-9, "crop": 30e-9,
                                 "window": 20e-9})
