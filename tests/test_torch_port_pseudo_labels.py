"""The port's pseudo-label factory against `usot_tpu`'s: the host half
(`flow2box`, the DP with a seeded generator, `crop_gen`, train.json)
equal on the same inputs; the cv2 counterparts it uses against cv2;
`inference_sequence` and `cli.parse_flow.main` end to end on the same
weights at a small test shape.

The flow network makes discontinuous decisions downstream (the adaptive
interval's 8 / 16 px thresholds, the distance map's threshold), so the
end-to-end parity is held in two steps: the port's host code on JAX's
inputs gives JAX's answers exactly, and the port's flow gives JAX's
decisions, each decision's margin from its threshold asserted to be at
least 100x the measured flow gap. Three flow regimes (a bias on the
flow head) take the loop's three branches: grow to 7, hold at 4, shrink
to 1.

JAX's `FlowHelper` is built once per module (its jitted forward compiles
in ~10 s) on variables from `jax.eval_shape`, never from an eager init.
"""
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import usot_tpu.preprocessing.crop_gen as jax_crop
import usot_tpu.preprocessing.flow2box as jax_f2b
import usot_tpu.preprocessing.inference as jax_inf
from usot_tpu.cli import parse_flow as jax_cli
from usot_tpu_torch.cli import parse_flow as port_cli
from usot_tpu_torch.data import cvops
from usot_tpu_torch.models.convert import pwclite_state_dict_from_flax
from usot_tpu_torch.preprocessing import crop_gen, flow2box, inference

from torch_port_common import jax_pwclite_variables

torch.set_num_threads(2)
TEST_SHAPE = (64, 96)
# predict_flow's dx bias -> the loop's regime on `_video`: max|flow| ~0.1
# (grow to 7; candidate boxes around the block), ~13 (hold at 4), ~20 px
# (shrink to 1); the biased flows hold no salient region, so no box
REGIMES = {"grow": 0.0, "hold": 0.08, "shrink": 0.12}


def _variables(bias):
    """The numpy-drawn kernels with zero biases (flax's init; random
    biases swamp the moving block in the distance map), but for
    predict_flow's dx bias."""
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: np.zeros_like(a) if p[-1].key == "bias"
        else np.asarray(a), jax_pwclite_variables(3, True, *TEST_SHAPE))
    v["params"]["flow_estimators"]["predict_flow"]["conv"]["bias"][0] = bias
    return v


@pytest.fixture(scope="module")
def jax_helper():
    return jax_inf.FlowHelper(variables=_variables(0.0),
                              test_shape=TEST_SHAPE)


def _port_helper(variables):
    return inference.FlowHelper(pwclite_state_dict_from_flax(variables),
                                test_shape=TEST_SHAPE, device="cpu")


def _video(n=14, h=96, w=128, seed=0):
    """A textured block moving right over a noise background, BGR uint8."""
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n):
        im = (rng.random((h, w, 3)) * 60).astype(np.uint8)
        x0 = 30 + 3 * f
        im[30:70, x0:x0 + 36] = [200, 160, 90]
        out.append(im)
    return out


def _write(frames, folder, ext):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, im in enumerate(frames):
        paths.append(os.path.join(folder, f"{i + 1:08d}.{ext}"))
        assert cv2.imwrite(paths[-1], im)
    return paths


# ------------------------------------------------------------- host half

def _flows(seed):
    """Flow fields flow_to_bbox sees: one moving block, two blocks (one
    hugging a corner), smooth noise, and a near-still field."""
    rng = np.random.default_rng(seed)
    h, w = 160, 224
    a = rng.normal(0, 0.3, (h, w, 2)).astype(np.float32)
    a[40:100, 60:150] += [6.0, 3.0]
    b = rng.normal(0, 0.2, (h, w, 2)).astype(np.float32)
    b[20:60, 30:90] += [-4.0, 1.0]
    b[110:158, 150:222] += [3.0, 5.0]
    c = cv2.GaussianBlur(rng.normal(0, 2, (h, w, 2)).astype(np.float32),
                         (0, 0), 9)
    d = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    return [a, b, c, d]


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_to_bbox_equals_jax(seed):
    found = 0
    for flow in _flows(seed):
        ours = flow2box.flow_to_bbox(flow)
        assert ours == jax_f2b.flow_to_bbox(flow)
        found += len(ours)
    assert found >= 4  # the candidate path runs, not only the empty one


def _candidates(seed, n_sampled, big=True):
    """Per sampled frame 0-3 candidate boxes drifting along a path, a few
    empty frames; with `big` every box's minimum coordinate exceeds 75 px,
    so the DP draws its perturbations."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_sampled):
        boxes = []
        for _ in range(rng.integers(0 if k % 4 else 1, 4)):
            x1 = (90 if big else 5) + 4 * k + rng.uniform(-10, 10)
            y1 = (80 if big else 5) + 2 * k + rng.uniform(-10, 10)
            boxes.append((x1, y1, x1 + rng.uniform(30, 80),
                          y1 + rng.uniform(30, 80)))
        out.append(boxes)
    return out


@pytest.mark.parametrize("length,gap,big", [(40, 3, True), (41, 3, False),
                                            (25, 1, True)])
def test_smooth_bbox_dp_and_freqs_equal_jax(length, gap, big):
    """The DP with its perturbations drawn (`np.random.seed(s)` for JAX,
    `RandomState(s)` for the port), the nearby and corner frequencies."""
    n_sampled = len(range(gap, length - gap, gap))
    boxes = _candidates(length, n_sampled, big)
    np.random.seed(5)
    ref = jax_f2b.smooth_bbox_dp(boxes, length, gap=gap)
    rng = np.random.RandomState(5)
    ours = flow2box.smooth_bbox_dp(boxes, length, gap=gap, rng=rng)
    assert ours == ref
    # the perturbations were drawn exactly where the boxes are large
    assert (rng.uniform() != np.random.RandomState(5).uniform()) == big
    np.random.seed(5)  # rng=None: numpy's global state, as JAX
    assert flow2box.smooth_bbox_dp(boxes, length, gap=gap) == ref
    for r in ([3, 10], [2, 5]):
        assert flow2box.calc_nearby_bbox_freq(
            ours[1], length, search_range=r, gap=gap) \
            == jax_f2b.calc_nearby_bbox_freq(ref[1], length, search_range=r,
                                             gap=gap)
    assert flow2box.calc_corner_bbox_freq(ours[0], (300, 400)) \
        == jax_f2b.calc_corner_bbox_freq(ref[0], (300, 400))


def _raw(seed, n_videos=3, n=30):
    rng = np.random.default_rng(seed)
    raw = {}
    for v in range(n_videos):
        x, y = rng.uniform(20, 200, 2)
        frames, freq = [], []
        for f in range(n):
            x += rng.normal(0, 6 if f % 7 else 60)
            y += rng.normal(0, 4)
            s = rng.uniform(40, 60)
            frames.append([x, y, x + s, y + s * rng.uniform(0.8, 1.2)])
            freq.append([rng.uniform(0.2, 1.0), rng.uniform(0.2, 1.0)])
        raw[f"vid{v}"] = {"00": {"frames": frames, "freq": freq, "meta": {
            "bbox_picked_freq": [0.3, 0.6, 0.9][v],
            "corner_bbox_freq": [0.1, 0.5, 0.2][v],
            "frame_sz": [320, 240]}}}
    return raw


@pytest.mark.parametrize("gate", [True, False])
def test_memory_bounds_and_train_json_equal_jax(tmp_path, gate):
    raw = _raw(3)
    prohibit = tmp_path / "prohibit.txt"
    prohibit.write_text("vid0\n")
    for pro in (None, str(prohibit)):
        ours = crop_gen.build_train_json(raw, prohibit_file=pro,
                                         quality_gate=gate)
        assert ours == jax_crop.build_train_json(raw, prohibit_file=pro,
                                                 quality_gate=gate)
    assert len(crop_gen.build_train_json(raw, quality_gate=False)) == 3
    seq = [list(b) + list(f) for b, f in zip(raw["vid1"]["00"]["frames"],
                                             raw["vid1"]["00"]["freq"])]
    for idx in range(len(seq)):
        for sg, mfg in ((2, 320), (1, 5)):
            assert crop_gen.memory_bounds(seq, idx, sg, mfg) \
                == jax_crop.memory_bounds(seq, idx, sg, mfg)
        assert crop_gen.calc_corner_score(seq[idx], [320, 240]) \
            == jax_crop.calc_corner_score(seq[idx], [320, 240])
    path = tmp_path / "out" / "train.json"
    crop_gen.save_train_json(ours, str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(ours))


def test_resize_linear_equals_cv2():
    """Within 1e-4 of 255 on float32 RGB, shrinking (720p to the test
    shape), growing and odd sizes."""
    rng = np.random.default_rng(0)
    for (h, w), (dw, dh) in (((720, 1280), (640, 384)),
                             ((96, 128), (96, 64)), ((50, 70), (131, 97)),
                             ((33, 47), (20, 11))):
        im = (rng.random((h, w, 3)) * 255).astype(np.float32)
        ours = cvops.resize_linear(
            torch.from_numpy(im).permute(2, 0, 1)[None], dh, dw)
        err = np.abs(ours[0].permute(1, 2, 0).numpy()
                     - cv2.resize(im, (dw, dh))).max()
        assert err <= 1e-4 * 255, ((h, w), err)


def test_preprocess_matches_jax(jax_helper):
    """A 720x1280 RGB frame to the test shape in [0, 1]: the port's
    (uint8 uploaded, resized as float32) against JAX's (cv2 on the float32
    frame), within 1e-4 of the [0, 1] range (`resize_linear`'s limit);
    a frame at the test shape is not resized."""
    rng = np.random.default_rng(3)
    helper = _port_helper(_variables(0.0))
    for hw in ((720, 1280), TEST_SHAPE):
        rgb = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        ours = helper.preprocess(rgb).permute(1, 2, 0).numpy()
        ref = jax_helper.preprocess(rgb.astype(np.float32))
        assert ours.shape == ref.shape == (*TEST_SHAPE, 3)
        assert np.abs(ours - ref).max() <= 1e-4, hw


def test_warp_affine_border_value_equals_cv2():
    """A float64 per-channel border (cv2 rounds it to uint8 first) on
    crops that reach past every edge, within one grey level."""
    rng = np.random.default_rng(1)
    im = (rng.random((90, 120, 3)) * 255).astype(np.uint8)
    avg = np.mean(im, axis=(0, 1))
    for (x1, y1, x2, y2) in ((-40, -30, 60, 50), (70, 50, 170, 140),
                             (-60, -60, 200, 160), (100.5, -20.25, 140, 30)):
        a, b = 130 / (x2 - x1), 130 / (y2 - y1)
        m = np.array([[a, 0, -a * x1], [0, b, -b * y1]])
        for value in (avg, (0, 0, 0), (127.5, 300.0, -4.0)):
            ref = cv2.warpAffine(im, m, (131, 131),
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=value)
            ours = cvops.warp_affine(im, m, (131, 131), border_value=value)
            d = np.abs(ours.astype(int) - ref.astype(int))
            assert d.max() <= 1, ((x1, y1), value, d.max())


def test_crop_like_siamfc_equals_jax():
    """z and x crops (the reference's w/h swap kept), padded with the
    frame's mean, within one grey level; boxes near every edge."""
    rng = np.random.default_rng(2)
    im = (rng.random((240, 320, 3)) * 255).astype(np.uint8)
    avg = np.mean(im, axis=(0, 1))
    for box in ((10, 15, 70, 60), (250, 180, 318, 238), (100, 90, 160, 200),
                (0, 100, 300, 140)):
        ours = crop_gen.crop_like_siamfc(im, box, instance_size=255,
                                         padding=avg)
        ref = jax_crop.crop_like_siamfc(im, box, instance_size=255,
                                        padding=avg)
        for o, r in zip(ours, ref):
            assert o.shape == r.shape and o.dtype == r.dtype
            assert np.abs(o.astype(int) - r.astype(int)).max() <= 1, box


def test_crop_video_frames_reads_and_writes_through_its_arguments(tmp_path):
    frames = _video(4, 96, 128)
    written = {}
    boxes = [(20, 30, 60, 70)] * 4
    crop_gen.crop_video_frames(list(range(4)), boxes, 3, str(tmp_path / "v"),
                               instance_size=127,
                               reader=lambda i: frames[i] if i != 2 else None,
                               writer=lambda p, im: written.update({p: im}))
    assert sorted(os.path.basename(p) for p in written) == [
        "000000.03.x.jpg", "000001.03.x.jpg", "000003.03.x.jpg"]
    assert all(im.shape == (127, 127, 3) for im in written.values())


# -------------------------------------------------------------- end to end

def _jax_run(helper, paths, gap, init_adjacent):
    """JAX's run_sequence and inference_sequence on `paths`, with each
    forward's (lo, i, hi) and max|flow| recorded."""
    imgs = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB).astype(np.float32)
            for p in paths]
    pre, record = [], []
    preprocess, forward = helper.preprocess, helper._forward
    resize_flow = jax_inf.resize_flow

    def keep_pre(img):
        pre.append(preprocess(img))
        return pre[-1]

    def keep_forward(variables, triple):
        t = np.asarray(triple[0])
        record.append(tuple(next(k for k, p in enumerate(pre)
                                 if np.array_equal(t[..., 3 * j:3 * j + 3],
                                                   p)) for j in range(3)))
        return forward(variables, triple)

    def keep_max(flow, h, w):
        out = resize_flow(flow, h, w)
        record[-1] += (float(np.abs(np.asarray(out)).max()),)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(helper, "preprocess", keep_pre)
        mp.setattr(helper, "_forward", keep_forward)
        mp.setattr(jax_inf, "resize_flow", keep_max)
        flows = helper.run_sequence(imgs, imgs[0].shape[:2], gap,
                                    init_adjacent)
    np.random.seed(9)
    try:
        mined = jax_inf.inference_sequence(helper, paths, gap, init_adjacent)
    except ValueError as e:
        mined = e
    return flows, record, mined


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_inference_sequence_matches_jax(jax_helper, tmp_path, regime):
    """A 14-frame 96x128 video at test shape 64x96, the same weights:
    every (frame, interval) decision equal, each with a margin from 8 and
    16 px of at least 100x the flow gap; boxes within 1 px, the picked
    frames and frequencies equal."""
    variables = _variables(REGIMES[regime])
    jax_helper.variables = variables
    paths = _write(_video(), str(tmp_path / "v"), "png")
    gap, init_adjacent = 3, 4
    ref_flows, ref_dec, ref = _jax_run(jax_helper, paths, gap, init_adjacent)

    helper = _port_helper(variables)
    decisions = []
    flows = helper.run_sequence(
        [cv2.imread(p)[..., ::-1] for p in paths], (96, 128), gap,
        init_adjacent, decisions=decisions)
    n = len(paths)
    ours_dec = [(max(0, i - a), i, min(i + a, n - 1), m)
                for i, a, m in decisions]
    assert [d[:3] for d in ours_dec] == [d[:3] for d in ref_dec]
    flow_gap = max(float(np.abs(f - np.asarray(r)).max())
                   for f, r in zip(flows, ref_flows))
    for (*_, m), (*_, r) in zip(ours_dec, ref_dec):
        gap_m = max(abs(m - r), flow_gap)
        margin = min(abs(r - 8.0), abs(r - 16.0))
        assert margin >= 100 * gap_m, (r, m, flow_gap)
    assert decisions[-1][1] == {"grow": 7, "hold": 4, "shrink": 1}[regime]

    if regime != "grow":  # no candidate in any frame: both refuse
        assert isinstance(ref, ValueError)
        with pytest.raises(ValueError, match="no candidate boxes"):
            inference.inference_sequence(helper, paths, gap, init_adjacent)
        return
    boxes, picked, stats = inference.inference_sequence(
        helper, paths, gap, init_adjacent, rng=np.random.RandomState(9))
    ref_boxes, ref_picked, ref_stats = ref
    assert len(boxes) == len(ref_boxes) == n
    dev = np.abs(np.asarray(boxes) - np.asarray(ref_boxes)).max()
    print(f"{regime}: flow gap {flow_gap:.3g} px, boxes {dev:.3g} px")
    assert dev <= 1.0
    assert picked == ref_picked
    assert stats[0] == ref_stats[0]  # freq
    assert stats[1:3] == ref_stats[1:3]  # found / picked frequencies
    # frames held in memory give the same answer as their files
    again = inference.inference_sequence(
        helper, [cv2.imread(p) for p in paths], gap, init_adjacent,
        rng=np.random.RandomState(9))
    assert again[0] == boxes and again[1] == picked


def _dataset(root, n_videos, n_frames, seed):
    for v in range(n_videos):
        frames = _video(n_frames, seed=seed + v)
        _write(frames, os.path.join(root, f"video{v}"), "jpg")
    os.makedirs(os.path.join(root, "short"))  # < 10 frames: skipped
    _write(_video(5), os.path.join(root, "short"), "jpg")


@pytest.mark.parametrize("dataset,keep_all", [("got10k", True),
                                              ("ytvos", False)])
def test_parse_flow_main_matches_jax(jax_helper, tmp_path, monkeypatch,
                                     dataset, keep_all):
    """Both CLIs on a JPEG dataset the test writes, given the same
    ARFlow-layout `--flow_ckpt` (the grow regime's weights): raw.json
    within 1 px (the rest equal), train.json equal, every crop within one
    grey level of JAX's before JPEG encoding. got10k: the port's default
    reader and writer (cv2 here); ytvos (gap 1, interval 1): frames held
    in memory through `reader`, crops through `writer`."""
    data = str(tmp_path / "data")
    _dataset(data, 2, 12 if dataset == "got10k" else 10, 20)
    sd = pwclite_state_dict_from_flax(_variables(REGIMES["grow"]))
    ckpt = str(tmp_path / "pwclite_ar_mv.tar")
    torch.save({"epoch": 1, "state_dict": {"module." + k: v
                                           for k, v in sd.items()}}, ckpt)

    crops = {"jax": {}, "port": {}}
    imwrite = cv2.imwrite

    def capture(side):
        def write(path, image):
            crops[side][os.path.relpath(path, str(tmp_path / side))] = image
            return True
        return write

    def argv(side):
        a = ["--data_dir", data, "--output_dir", str(tmp_path / side),
             "--dataset", dataset, "--flow_ckpt", ckpt]
        return a + (["--keep_all"] if keep_all else [])

    jax_helper.variables = _variables(REGIMES["shrink"])  # the tar's win
    monkeypatch.setattr(jax_inf, "FlowHelper", lambda: jax_helper)
    monkeypatch.setattr(cv2, "imwrite", capture("jax"))
    np.random.seed(4)
    jax_cli.main(argv("jax"))

    def small(device=None):
        return inference.FlowHelper(test_shape=TEST_SHAPE, device=device)

    monkeypatch.setattr(port_cli, "FlowHelper", small)
    np.random.seed(4)
    if dataset == "got10k":
        monkeypatch.setattr(cv2, "imwrite", capture("port"))
        port_cli.main(argv("port") + ["--device", "cpu"])
    else:
        monkeypatch.setattr(cv2, "imwrite", imwrite)
        frames = {}

        def reader(path):
            if path not in frames:
                frames[path] = cv2.imread(path)
            return frames[path]

        port_cli.main(argv("port") + ["--device", "cpu"], reader=reader,
                      writer=capture("port"))
        assert len(frames) == 20

    def load(side, name):
        with open(tmp_path / side / name) as f:
            return json.load(f)

    raw, ref_raw = load("port", "raw.json"), load("jax", "raw.json")
    assert sorted(raw) == sorted(ref_raw) == ["video0", "video1"]
    for video in raw:
        ours, ref = raw[video]["00"], ref_raw[video]["00"]
        dev = np.abs(np.asarray(ours["frames"])
                     - np.asarray(ref["frames"])).max()
        print(f"{dataset} {video}: boxes {dev:.3g} px")
        assert dev <= 1.0
        assert ours["freq"] == ref["freq"] and ours["meta"] == ref["meta"]
    assert load("port", "train.json") == load("jax", "train.json")
    assert sorted(crops["port"]) == sorted(crops["jax"])
    assert len(crops["port"]) == 2 * (12 if dataset == "got10k" else 10)
    off = 0
    for name, image in crops["port"].items():
        assert image.shape == (511, 511, 3)
        d = np.abs(image.astype(int) - crops["jax"][name].astype(int))
        assert d.max() <= 1, name
        off += int((d > 0).sum())
    print(f"{dataset}: crops {off / (len(crops['port']) * 511 * 511 * 3):.3g}"
          " of the values one level off")
