"""The plain reference against the port's modules and steps at small
widths (w8c32) and B=2 on the CPU. The test imports the port; the
reference does not."""
import numpy as np
import pytest
import torch

from conftest import ROOT, small_context
from portbench import harness
from portbench.reference.net import Net
from portbench.reference.train import forward, leaves
from portbench.weights import make_weights

SEED = 2 ** 31 + 5
# every reading's mean, to read them all (the limits themselves apply to
# the bf16 configuration)
READ = {k: {"gap_mean": 1.0, "box_px_mean": 1.0, "score_mean": 1.0}
        for k in ("engine_staged", "tracker_live")}


@pytest.fixture(scope="module")
def weights():
    from portbench.weights import calibrate

    w = make_weights(SEED, 8, 32, "cpu")
    gen = torch.Generator().manual_seed(1)
    crops = {"z": torch.rand((2, 127, 127, 3), generator=gen) * 255,
             "x": torch.rand((2, 255, 255, 3), generator=gen) * 255,
             "tb": torch.tensor([[3.0, 3.0, 11.0, 11.0]] * 2),
             "sb": torch.tensor([[5.0, 5.0, 19.0, 19.0]] * 2)}
    return calibrate(w, crops)


def port(weights, **kw):
    from usot_tpu_torch.models.usot import build_usot

    m = build_usot(mem_size=4, width=8, channels=32, **kw)
    m.load_state_dict(weights)
    return m.eval()


def nchw(t):
    return t.permute(0, 3, 1, 2)


@torch.no_grad()
def test_network_matches_port(weights):
    m, net = port(weights), Net(weights)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((2, 255, 255, 3), generator=gen) * 255
    z = torch.rand((2, 127, 127, 3), generator=gen) * 255
    tb = torch.tensor([[3.0, 3.0, 11.0, 11.0], [2.0, 4.0, 12.0, 10.0]])
    mem = torch.randn((2, 7, 7, 7, 32), generator=gen)
    xf, zf = m.search_features(x), m.template_features(z, tb)
    cls, bbox, cls_mem = m.track_memory_batched(xf, zf, mem)
    rxf, rzf = net.features(x), net.template(z, tb)
    torch.testing.assert_close(nchw(xf), rxf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(nchw(zf), rzf, rtol=1e-4, atol=1e-4)
    cls_x = net.encode(rxf, "cls", "s")
    rbbox, rcls = net.offline(net.encode(rzf, "cls", "k"),
                              net.encode(rzf, "reg", "k"), cls_x,
                              net.encode(rxf, "reg", "s"))
    rmem = net.memory(cls_x, net.encode(nchw(mem.reshape(14, 7, 7, 32)),
                                        "cls", "k"), 7)
    for a, b in ((cls, rcls), (bbox, rbbox), (cls_mem, rmem)):
        torch.testing.assert_close(nchw(a), b, rtol=1e-4, atol=1e-4)


def test_engine_followed_exactly_in_float32():
    """The batch engine in float32 at B=2: the reference following its
    outputs reads no gap and agrees to round-off."""
    bench, ctx = small_context("track_b64_staged",
                               config={"dtype": "float32", "limits": READ})
    line = harness.run_cell(ctx, bench)
    checks = line["checks"]
    assert checks["gap_mean"]["value"] == 0.0
    assert checks["box_px_mean"]["value"] < 1e-3
    assert checks["score_mean"]["value"] < 1e-4


def test_tracker_followed_exactly_in_float32():
    """The B=1 tracker in float32: as the engine, but its host crops round
    to uint8, and a pixel whose value lands half-way can round the other
    way in the reference's resize (one grey level at a few pixels)."""
    bench, ctx = small_context("track_b1_live",
                               config={"dtype": "float32", "limits": READ})
    checks = harness.run_cell(ctx, bench)["checks"]
    assert checks["gap_mean"]["value"] == 0.0
    assert checks["box_px_mean"]["value"] < 1e-2
    assert checks["score_mean"]["value"] < 1e-3


def test_training_step_matches_port_in_float64():
    """One cycle-memory step's gradients in float64: the reference and
    the port's `forward_train` agree to 1e-6 of the largest leaf."""
    from usot_tpu_torch.models.usot import build_usot

    w = {k: v.double() for k, v in make_weights(SEED, 8, 32, "cpu").items()}
    gen = torch.Generator().manual_seed(3)
    b = {"template": torch.randn((2, 127, 127, 3), generator=gen),
         "search": torch.randn((2, 255, 255, 3), generator=gen),
         "label": (torch.rand((2, 25, 25), generator=gen) > 0.8).double(),
         "reg_target": torch.randn((2, 25, 25, 4), generator=gen).abs() + 1,
         "reg_weight": (torch.rand((2, 25, 25), generator=gen) > 0.7)
         .double(),
         "template_bbox": torch.tensor([[3.0, 3.0, 11.0, 11.0]] * 2),
         "search_memory": torch.randn((2, 2, 255, 255, 3), generator=gen),
         "search_bbox": torch.tensor([[5.0, 5.0, 19.0, 19.0]] * 2)}
    b = {k: v.double() for k, v in b.items()}
    names = list(leaves(8, 32))
    params = {k: w[k].clone().requires_grad_(True) for k in names}
    cls, mem, reg = forward(Net({**w, **params}, mode="train"), b, 0.5)
    ref = torch.autograd.grad(0.3 * cls + 0.6 * mem + reg,
                              [params[k] for k in names])
    m = build_usot(mem_size=2, width=8, channels=32)
    m.load_state_dict({k: v.float() for k, v in w.items()})
    m.to(torch.float64)
    own = dict(m.named_parameters())
    lo, lm, lr = m.forward_train(
        b["template"], b["search"], b["label"], b["reg_target"],
        b["reg_weight"], b["template_bbox"], search_memory=b["search_memory"],
        search_bbox=b["search_bbox"], cls_ratio=0.5, stage_bn_train=True)
    got = torch.autograd.grad(0.3 * lo + 0.6 * lm + lr,
                              [own[k] for k in names])
    scale = max(float(g.abs().max()) for g in ref)
    for k, g, r in zip(names, got, ref):
        assert float((g - r).abs().max()) < 1e-6 * scale, k
    assert float(lo) == pytest.approx(float(cls), rel=1e-6)  # float32 losses
    assert float(lm) == pytest.approx(float(mem), rel=1e-6)


def test_training_cell_follows_three_steps():
    """The training cell's check at B=2: the first loss to 1e-4, and no
    leaf of the gradient, the change or the statistics off by half."""
    bench, ctx = small_context("train_cycle_b12")
    checks = harness.run_cell(ctx, bench)["checks"]
    assert checks["loss_step1"]["value"] < 1e-4
    for k in ("grad", "change", "stats"):
        assert checks[k]["value"] < 0.5, k


def _tracker():
    from portbench.reference.tracker import Tracker

    cfg = harness.load_json(
        ROOT / "portbench/configs/usot_star_r50_bf16.json")["tracker"]
    return Tracker(None, cfg)


@pytest.mark.parametrize("case", ["coincide", "apart"])
def test_match_takes_the_best_of_cells_with_the_programs_box(case):
    """Three cells: the best (pscore 0.6) and a worse one whose score is
    nearer the program's. Where their boxes coincide (a size at its
    floor, a centre at the image's edge) the box cannot tell them apart
    and the best is taken; where they lie a cell's stride apart (8 px at
    scale 1), the box decides. A third cell lies far off."""
    apart = 8.0 if case == "apart" else 0.0
    cand = {"pos": np.array([[[100.0, 0.0], [100.0 + apart, 0.0],
                               [160.0, 40.0]]]),
            "sz": np.full((1, 3, 2), 10.0),
            "score": np.array([[0.52, 0.50, 0.50]]),
            "pscore": np.array([[0.60, 0.55, 0.40]])}
    pos, sz, score = (np.array([[100.0 + apart, 0.0]]), np.array([[10.0,
                      10.0]]), np.array([0.50]))
    k, dist, miss = _tracker().match(cand, pos, sz, score, np.ones(1))
    assert k.tolist() == ([1] if case == "apart" else [0])
    assert dist[0, 2] == pytest.approx(60.0 - apart)


def test_match_falls_back_to_the_nearest_cell():
    """No cell's box lies within a quarter stride: the cell whose box and
    score lie nearest is taken, whatever its penalised score."""
    cand = {"pos": np.array([[[100.0, 50.0], [112.0, 50.0]]]),
            "sz": np.full((1, 2, 2), 40.0),
            "score": np.array([[0.6, 0.5]]),
            "pscore": np.array([[0.7, 0.5]])}
    k, _, _ = _tracker().match(cand, np.array([[109.0, 50.0]]),
                               np.array([[40.0, 40.0]]), np.array([0.5]),
                               np.ones(1))
    assert k.tolist() == [1]
