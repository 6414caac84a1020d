"""OSTrack in the port (`models/ostrack.py`, `models/vit_ce.py`,
`ops/attention.py`, `core/crop.py::sample_target_gather`,
`tracker/ostrack_engine.py`, `cli/test.py --arch OSTrack-384`) against
the plain reference `tests/ostrack_reference.py`, on the CPU in float32
at a small size: width 64, 4 heads, all 12 blocks with CE at 3/6/9, a
48-px template (3 x 3 tokens, the centre token (1, 1)) and a 64-px search
(16 tokens, kept 12 -> 9 -> 7).

Tolerances: the port's attention is `F.scaled_dot_product_attention` and
its CE row a side computation, the reference's an explicit softmax: the
same float32 sums in another order, so maps agree to ~1e-6 relative and
the kept sets exactly (ties between tokens are measure-zero on seeded
weights). Crops are the same float32 arithmetic on both sides: equal.
This file imports no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

import ostrack_reference as ref
from usot_tpu_torch.core.crop import sample_target_gather
from usot_tpu_torch.models import vit_ce
from usot_tpu_torch.models.ostrack import (UNUSED_KEYS, build_ostrack,
                                           fold_center_head,
                                           load_ostrack_state)
from usot_tpu_torch.tracker.ostrack_engine import OSTrackBatchEngine

torch.set_num_threads(2)
CPU = torch.device("cpu")
PORT = dict(dim=64, depth=12, heads=4, hidden=256, patch=16, template=48,
            search=64, head_channels=32, ce_loc=(3, 6, 9), keep=0.7)
SMALL = dict(ref.SIZES, dim=64, heads=4, mlp=256, template=48, search=64,
             head_channels=32)


def seeded_model(seed=0, dtype=torch.float32):
    """The small model with seeded weights: lecun-normal linears and
    convs, the q and k rows of qkv 4x wider (peaked attention, so CE's
    ranking is not near-uniform), noisy LayerNorms, biases and position
    tables, BN statistics spread."""
    g = torch.Generator().manual_seed(seed)
    model = build_ostrack(dtype=dtype, **PORT)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 1.5 + 0.5)
            elif t.dim() >= 2 and "pos_embed" not in name:
                std = (1.0 / t[0].numel()) ** 0.5
                t.copy_(torch.randn(t.shape, generator=g) * std)
                if name.endswith("qkv.weight"):
                    t[:2 * PORT["dim"]] *= 4.0
            else:
                base = 1.0 if name.endswith(("norm1.weight", "norm2.weight",
                                             "norm.weight", ".1.weight")) \
                    else 0.0
                t.copy_(base + 0.3 * torch.randn(t.shape, generator=g))
    return model.eval()


def weights(model):
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def normalised(seed, side, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3, side, side), generator=g) * 4 - 2


@pytest.fixture(scope="module")
def model():
    return seeded_model()


def test_model_matches_reference(model, monkeypatch):
    """Score, size and offset maps, the kept sets at each stage, and the
    map of the CE stages that kept each search position."""
    kept = []
    real = vit_ce.CEBlock.eliminate

    def recording(self, x, row, index, lens_t):
        out = real(self, x, row, index, lens_t)
        kept.append(out[1].sort(dim=1).values)
        return out
    monkeypatch.setattr(vit_ce.CEBlock, "eliminate", recording)
    z, x = normalised(1, 48), normalised(2, 64)
    with torch.no_grad():
        ours = model(model.embed_template(z), x)
        want = ref.forward(z, x, weights(model), SMALL)
    for got, name in zip(ours, ("score", "size", "offset")):
        torch.testing.assert_close(got, want[name], rtol=1e-5, atol=1e-5)
    assert [k.shape[1] for k in kept] == ref.kept_counts(SMALL) == [12, 9, 7]
    for a, b in zip(kept, want["kept"]):
        assert torch.equal(a, b)
    assert torch.equal(ours[3], ref.stages(want["kept"], 2, 16))
    assert sorted(torch.bincount(ours[3][0].long()).tolist()) == [2, 3, 4, 7]
    # the ranking is not near-uniform: the kept sets differ by lane
    assert not torch.equal(kept[-1][0], kept[-1][1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_folded_head_matches_unfolded(model, dtype, tol):
    """BN folded into the convs (float32, then the compute dtype) against
    the head's own conv-BN-ReLU in that dtype; bf16 rounds each layer's
    output once on both sides, in different places."""
    feat = normalised(3, 4, n=3).repeat(1, 22, 1, 1)[:, :64].to(dtype)
    head = model.box_head
    with torch.no_grad():
        plain = head(feat)
        folded = head(feat, fold_center_head(head, dtype))
    for a, b in zip(folded, plain):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


def synthetic(seed, lanes=3, frames=9, h=72, w=96):
    """Noise frames with a solid box per lane moving 1-2 px a frame;
    lane 0 starts at the left edge, lane 2's image is 64 x 80 on the
    72 x 96 canvas. Returns (canvas frames (B, T, h, w, 3) uint8, images'
    (h, w), init boxes (B, 4) [x, y, w, h])."""
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (lanes, frames, h, w, 3), dtype=np.uint8)
    hw = [(h, w), (h, w), (64, 80)][:lanes]
    starts = [(2, 20, 14, 12), (40, 30, 16, 18), (30, 24, 12, 14)][:lanes]
    for i, (x0, y0, bw, bh) in enumerate(starts):
        colour = rng.integers(0, 256, 3)
        for f in range(frames):
            x = x0 + f * (1 + i % 2)
            video[i, f, y0:y0 + bh, x:x + bw] = colour
        video[i, :, hw[i][0]:] = 0
        video[i, :, :, hw[i][1]:] = 0
    return video, hw, np.array(starts, np.float64)


def test_engine_tracks_as_reference(model):
    """3 lanes over 8 tracked frames: the engine against the reference
    tracker running free (its own picks), boxes within 1e-3 px."""
    video, hw, boxes = synthetic(4)
    engine = OSTrackBatchEngine(model, batch=3, chunk=4,
                                device="cpu")
    inits = [(video[i, 0, :h, :w], boxes[i, :2] + boxes[i, 2:] / 2,
              boxes[i, 2:]) for i, (h, w) in enumerate(hw)]
    state = engine.init_batch(inits)
    _, pos, sz, score, stages = engine.track_batch(state, video[:, 1:],
                                                   np.full(3, 8))
    tracker = ref.Tracker(weights(model), SMALL)
    frames = [video[i, :, :h, :w] for i, (h, w) in enumerate(hw)]
    rpos, rsz, rscore, rstages = tracker.track(frames, boxes)
    np.testing.assert_allclose(pos, rpos, atol=1e-3, rtol=0)
    np.testing.assert_allclose(sz, rsz, atol=1e-3, rtol=0)
    np.testing.assert_allclose(score, rscore, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(stages, rstages)
    assert np.ptp(pos[:, :, 0]) > 1.0   # the boxes move


def test_reference_follows_a_programs_kept_sets(model):
    """Following the program's outputs, the reference keeps the program's
    CE sets and counts the tokens of its own top sets the program
    dropped: none on the program's own sets; on lane 0's sets with one
    position the first stage kept traded for one it dropped, one at that
    stage, and the traded sets kept."""
    video, hw, boxes = synthetic(4)
    engine = OSTrackBatchEngine(model, batch=3, chunk=4, device="cpu")
    inits = [(video[i, 0, :h, :w], boxes[i, :2] + boxes[i, 2:] / 2,
              boxes[i, 2:]) for i, (h, w) in enumerate(hw)]
    _, pos, sz, score, stages = engine.track_batch(
        engine.init_batch(inits), video[:, 1:], np.full(3, 8))
    tracker = ref.Tracker(weights(model), SMALL)
    frames = [video[i, :, :h, :w] for i, (h, w) in enumerate(hw)]
    _, reads = tracker.track(frames, boxes, forced=(pos, sz, score, stages))
    assert reads["swaps"].max() == 0
    assert reads["gap"].max() < 1e-6
    traded = stages[:, 0].copy()
    p, q = np.flatnonzero(traded[0] >= 1)[0], np.flatnonzero(traded[0] == 0)[0]
    traded[0, [p, q]] = traded[0, [q, p]]
    got = tracker.candidates([f[1] for f in frames], boxes, tracker.init(
        [f[0] for f in frames], boxes), traded)
    np.testing.assert_array_equal(got["stages"], traded)
    assert got["swaps"][0].tolist() == [1, 0, 0]
    assert got["swaps"][:, 1:].max() == 0


# (frame h, w), box [x, y, w, h], factor, output side
CROPS = {
    "inside": ((120, 160), (60.0, 40.0, 20.0, 16.0), 2.0, 48),
    "left_top": ((120, 160), (-3.5, -2.0, 18.0, 14.0), 5.0, 64),
    "right_bottom_edge": ((120, 160), (150.2, 110.7, 12.0, 10.0), 2.0, 48),
    "last_column": ((120, 160), (130.0, 50.0, 20.0, 20.0), 1.5, 32),
    "larger_than_frame": ((60, 80), (10.0, 8.0, 50.0, 40.0), 5.0, 64),
    "upscaled": ((120, 160), (80.0, 60.0, 6.0, 7.0), 2.0, 48),
    "half_pixel_centre": ((120, 160), (70.25, 60.5, 9.0, 9.0), 2.0, 48),
}


@pytest.mark.parametrize("case", list(CROPS))
def test_crop_matches_sample_target(case):
    """The device crop against the numpy `sample_target` (OSTrack's
    arithmetic): within one grey level, and the same resize factor; the
    image's last column and row read zero where the window reaches
    them."""
    (h, w), box, factor, out = CROPS[case]
    rng = np.random.default_rng(len(case))
    im = rng.integers(1, 256, (h, w, 3), dtype=np.uint8)
    canvas = np.zeros((1, h + 8, w + 16, 3), np.uint8)
    canvas[0, :h, :w] = im
    got, crop_sz = sample_target_gather(
        torch.from_numpy(canvas), torch.tensor([box], dtype=torch.float64),
        factor, out, torch.tensor([[h, w]], dtype=torch.float64))
    want, resize = ref.sample_target(im, box, factor, out)
    assert np.abs(got[0].numpy() - want.astype(np.float32)).max() <= 1.0
    assert out / float(crop_sz[0]) == resize


def test_ce_kept_counts(model):
    """Tokens kept at each stage, summed over lanes and frame steps (the
    init runs no block), in float32 and bfloat16."""
    video, hw, boxes = synthetic(5)
    for dtype in (torch.float32, torch.bfloat16):
        m = seeded_model(dtype=dtype)
        engine = OSTrackBatchEngine(m, batch=3, chunk=4,
                                    device="cpu")
        inits = [(video[i, 0, :h, :w], boxes[i, :2] + boxes[i, 2:] / 2,
                  boxes[i, 2:]) for i, (h, w) in enumerate(hw)]
        vit_ce.reset_ce_kept_counts()
        state = engine.init_batch(inits)
        assert vit_ce.ce_kept_counts() == []
        _, pos, *_ = engine.track_batch(state, video[:, 1:], np.full(3, 8))
        assert vit_ce.ce_kept_counts() == [12 * 3 * 8, 9 * 3 * 8, 7 * 3 * 8]
        assert np.isfinite(pos).all()


def test_loads_a_state_dict_in_ostrack_layout(tmp_path, model):
    """A checkpoint as OSTrack saves it ({"net": state dict}, with MAE's
    unused `pos_embed` and `cls_token`) loads by key name; a missing key
    raises."""
    state = {k: torch.randn(s) for k, s in ref.param_shapes(SMALL).items()}
    for k in state:
        if k.endswith("running_var"):
            state[k] = state[k].abs() + 0.5
    assert set(state) == {k for k in model.state_dict()
                          if not k.endswith("num_batches_tracked")}
    full = dict(state, **{"backbone.pos_embed": torch.zeros(1, 17, 64),
                          "backbone.cls_token": torch.zeros(1, 1, 64)})
    assert set(UNUSED_KEYS) == {"backbone.pos_embed", "backbone.cls_token"}
    torch.save({"net": full, "epoch": 300}, tmp_path / "ck.pth.tar")
    fresh = build_ostrack(**PORT)
    load_ostrack_state(fresh, torch.load(tmp_path / "ck.pth.tar"))
    for k, v in state.items():
        assert torch.equal(fresh.state_dict()[k], v)
    del full["backbone.blocks.4.mlp.fc1.bias"]
    with pytest.raises(RuntimeError, match="fc1.bias"):
        load_ostrack_state(build_ostrack(**PORT), full)


def test_benchmark_reference_is_this_reference():
    """`portbench/reference/ostrack.py` is a copy of this file's
    reference, not an import of it."""
    here = os.path.dirname(__file__)
    with open(os.path.join(here, "ostrack_reference.py")) as a, \
            open(os.path.join(here, "..", "portbench", "reference",
                              "ostrack.py")) as b:
        assert a.read() == b.read()


def test_cli_tracks_a_dataset(tmp_path, monkeypatch, model):
    """`cli.test --arch OSTrack-384 --engine batch` over an OTB-layout
    dataset (frames from a reader, BGR), one lane per video, against the
    engine on the same frames in RGB."""
    import usot_tpu_torch.cli.test as cli
    import usot_tpu_torch.models.ostrack as ostrack

    video, hw, boxes = synthetic(6, lanes=2, frames=6, h=72, w=96)
    frames, meta = {}, {}
    for i, name in enumerate(("Car1", "Walk2")):
        names = [f"{name}/img/{f + 1:04d}.png" for f in range(6)]
        for n, im in zip(names, video[i]):
            frames[str(tmp_path / "OTB2015" / n)] = im[..., ::-1].copy()
        gt = [list(boxes[i] + [1, 1, 0, 0])] * 6
        meta[name] = {"video_dir": name, "init_rect": gt[0],
                      "img_names": names, "gt_rect": gt, "attr": []}
    (tmp_path / "OTB2015").mkdir()
    (tmp_path / "OTB2015.json").write_text(json.dumps(meta))
    monkeypatch.setattr(ostrack, "build_ostrack",
                        lambda dtype: seeded_model(dtype=dtype))
    monkeypatch.setattr(ostrack, "init_ostrack", lambda m, g: m)
    cli.main(["--arch", "OSTrack-384", "--engine", "batch", "--device",
              "cpu", "--dataset", "OTB2015", "--dataset_root",
              str(tmp_path), "--result_dir", str(tmp_path / "res"),
              "--batch", "2", "--chunk", "4",
              "--resume", str(tmp_path / "absent.pth.tar")],
             reader=lambda p: frames[str(p)])
    engine = OSTrackBatchEngine(model, batch=2, chunk=4,
                                device="cpu")
    canvas = np.zeros((2, 6, 128, 128, 3), np.uint8)
    canvas[:, :, :72, :96] = video
    rects = []
    for name in ("Car1", "Walk2"):
        rects.append(np.loadtxt(tmp_path / "res" / "OTB2015" / "OSTrack-384"
                                / f"{name}.txt", delimiter=","))
    from usot_tpu_torch.core.geometry import get_axis_aligned_bbox
    inits = []
    for i, name in enumerate(("Car1", "Walk2")):
        cx, cy, w, h = get_axis_aligned_bbox(
            np.asarray(meta[name]["gt_rect"][0]) - [1, 1, 0, 0])
        inits.append((video[i, 0], np.array([cx, cy]), np.array([w, h])))
    state = engine.init_batch(inits)
    _, pos, sz, *_ = engine.track_batch(state, canvas[:, 1:], np.full(2, 5))
    for i in range(2):
        assert rects[i].shape == (6, 4)
        np.testing.assert_allclose(rects[i][1:, :2] - 1,
                                   pos[i] - sz[i] / 2, atol=1e-9)
        np.testing.assert_allclose(rects[i][1:, 2:], sz[i], atol=1e-9)
