"""The port's step attribution (`usot_tpu_torch.tools.microbench_step`)
and its cost model (`usot_tpu_torch.tools.stage_cost`), on the CPU.

* Every stage's output at B=2 against what the JAX tool
  (`tools/microbench_step.py`) calls for it, on the same numpy inputs and
  the trained fixture, in float32, within the scale-aware 1e-4 of
  `tests/test_reference_parity.py:34-39` (the integer ring bookkeeping
  exactly); the FULL STEP against `BatchScanEngine(impl="native").
  _frame_step_batched`.
* The backbone prefixes: the +layer3 prefix is the backbone.
* Operation counts: the backbone+neck's equals the analytic count of its
  convolutions from the port module's shapes; every stage's count per
  sample is the same at B=1, 2 and 3; K1 and K3 calls add their analytic
  counts (2 per multiply-add) whatever the device.
* Bytes: a gather counts the rows it reads; an in-place ring write the
  rows it writes.
* The roofline arithmetic on given numbers; the tool's record and its
  `var/mfu_inference.json` at B=2 on the CPU (no device time), the vmap
  row named as having no counterpart, `--s2d`/`--s2b` raising.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn

from usot_tpu_torch.models.layers import Conv2d
from usot_tpu_torch.tools import microbench_step as mb
from usot_tpu_torch.tools import stage_cost as sc
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.engine import BatchScanEngine

from torch_port_common import (CHANNELS, FIXTURE, WIDTH, jax_step_refs,
                               leaves, scaled_err, step_setup)

torch.set_num_threads(2)
B, MAXF = 2, 48
CPU = torch.device("cpu")
NCHW_OUT = {"  memory tower+pred", "  offline towers+preds"}


def _config():
    p = TrackerConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


@pytest.fixture(scope="module")
def outputs():
    """The port's stage outputs (copied as they come out, in the tool's
    order) and JAX's reference functions on the same inputs."""
    from usot_tpu.tracker.config import TrackerConfig as JaxConfig

    s = step_setup(B, MAXF)
    p = _config()
    engine = BatchScanEngine(s.fused, p, mb.H, mb.W, batch=B,
                             max_frames=MAXF, chunk=8, device="cpu")
    ours = {}
    with torch.inference_mode():
        for name, fn in mb.stages(s.fused, engine, s.t, p):
            ours[name] = [a.copy() for a in leaves(fn())]
    jp = JaxConfig()
    jp.instance_size = jp.small_sz
    jp.renew()
    jp.sf_size = jp.score_size
    return ours, jax_step_refs(s.jm, s.v, s.inp, jp)


STAGES = ["crop (u8 frames->255)", "backbone+neck", "offline head",
          "offline+memory head", "ENC offline+memory head",
          "ENC+FOLDED head", "  encode_search (6 convs)",
          "  groupdw multi (fused)", "  conf_fusion (B*M maps)",
          "  memory tower+pred", "  offline towers+preds",
          "queue assembly", "memory write", "memory write ENC (scatter)",
          "memory write ENC (shared)", "prpool feature",
          "xcorr shift (1 pair 7x7)", "FULL STEP (native batched)"]


def test_the_stage_list_is_the_jax_tools():
    engine = SimpleNamespace()
    with torch.inference_mode():
        s = step_setup(1, MAXF)
        names = [n for n, _ in mb.stages(s.fused, engine, s.t, _config())]
    assert names == STAGES


@pytest.mark.parametrize("name", STAGES)
def test_stage_equals_the_jax_tools(outputs, name):
    ours, refs = outputs
    want = leaves(refs[name]())
    got = ours[name]
    if name in NCHW_OUT:
        got = [np.transpose(a, (0, 2, 3, 1)) for a in got]
    assert len(got) == len(want), name
    for a, w in zip(got, want):
        assert a.shape == w.shape, (name, a.shape, w.shape)
        assert scaled_err(a, w) <= 1e-4, (name, scaled_err(a, w))


def test_backbone_prefixes_end_in_the_backbone():
    s = step_setup(B, MAXF)
    with torch.inference_mode():
        pre = [fn() for _, fn in mb.prefix_stages(s.fused, s.t)]
        whole = s.fused.features(s.t["x_crop"])
    assert [tuple(x.shape) for x in pre] == [
        (B, 63, 63, WIDTH), (B, 63, 63, 4 * WIDTH), (B, 31, 31, 8 * WIDTH),
        (B, 31, 31, 16 * WIDTH)]
    assert torch.equal(pre[-1], whole)


def _conv_flops(module: nn.Module, x_shape) -> float:
    """2 * out elements * (in channels / groups) * kh * kw over every
    Conv2d the backbone+neck runs on an input of `x_shape` (NHWC),
    from the modules' own shapes (a forward hook records each output)."""
    total = [0.0]

    def hook(m, _, out):
        total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) \
            * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, Conv2d)]
    with torch.inference_mode():
        module.search_features(torch.zeros(x_shape))
    for h in handles:
        h.remove()
    return total[0]


def test_backbone_flops_are_the_analytic_count():
    s = step_setup(B, MAXF)
    counts = sc.stage_counts(lambda: s.fused.search_features(s.t["x_crop"]))
    assert counts["kernel_flops"] == 0
    assert counts["aten_flops"] == _conv_flops(s.fused,
                                               s.t["x_crop"].shape)


@pytest.fixture(scope="module")
def per_sample():
    """{stage: [operations per sample at B=1, 2, 3]}."""
    out = {}
    for b in (1, 2, 3):
        s = step_setup(b, MAXF)
        p = _config()
        engine = BatchScanEngine(s.fused, p, mb.H, mb.W, batch=b,
                                 max_frames=MAXF, chunk=8, device="cpu")
        with torch.inference_mode():
            for name, fn in mb.stages(s.fused, engine, s.t, p):
                c = sc.stage_counts(fn)
                out.setdefault(name, []).append(
                    (c["aten_flops"] + c["kernel_flops"]) / b)
    return out


@pytest.mark.parametrize("name", STAGES)
def test_operations_per_sample_do_not_depend_on_the_batch(per_sample, name):
    ops = per_sample[name]
    assert ops[0] == pytest.approx(ops[1], rel=1e-12) \
        == pytest.approx(ops[2], rel=1e-12)


def test_correlation_calls_add_their_analytic_counts():
    from usot_tpu_torch.ops.xcorr import (xcorr_depthwise_pairwise,
                                          xcorr_groupdw)

    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(s, np.float32))
          for s in ((2, 29, 29, 8), (2, 27, 29, 8), (2, 29, 27, 8))]
    ks = [torch.from_numpy(rng.standard_normal(s, np.float32))
          for s in ((2, 7, 5, 5, 8), (2, 7, 3, 5, 8), (2, 7, 5, 3, 8))]
    c = sc.stage_counts(lambda: xcorr_groupdw(xs, ks))
    assert c["kernel_flops"] == 2.0 * 2 * 7 * 8 * 25 * 25 * 55
    assert c["kernel_calls"] == {"K1": 1} and c["aten_flops"] == 0
    # inputs read once, the output written once; none of the plain
    # version's shift loop
    nbytes = sum(t.numel() * 4 for t in xs + ks) + 2 * 7 * 25 * 25 * 8 * 4
    assert c["op_bytes"] == nbytes and c["min_bytes"] == nbytes
    c = sc.stage_counts(lambda: xcorr_depthwise_pairwise(xs[0], ks[0][:, 0]))
    assert c["kernel_flops"] == 2.0 * 2 * 25 * 25 * 8 * 25
    assert c["kernel_calls"] == {"K3": 1}
    assert c["launches"] == {"K1": 0, "K2": 0, "K3": 0}   # the CPU


def test_index_ops_count_the_rows_they_move():
    from usot_tpu_torch.tracker.engine import _gather_slots, _scatter_slots

    ring = torch.zeros((2, 100, 3, 4))         # 2 lanes, 100 slots
    picks = torch.tensor([[1, 2], [3, 4]])
    row = 3 * 4 * 4
    c = sc.stage_counts(lambda: _gather_slots(ring, picks))
    # 4 rows read, the index read, 4 rows written
    assert c["min_bytes"] == 4 * row + picks.numel() * 8 + 4 * row
    feats = (torch.ones((2, 1, 3, 4)),)
    slots = torch.tensor([5, 6])
    c = sc.stage_counts(lambda: _scatter_slots((ring,), feats, slots))
    # the features and the slots read, 2 rows written: not the ring
    assert c["min_bytes"] == 2 * row + slots.numel() * 8 + 2 * row


def test_roofline_on_given_numbers():
    r = sc.roofline(989e9, 1e6, 2.0, "bf16")        # 1 ms of tensor work
    assert r["bound"] == "tensor" and r["bound_ms"] == pytest.approx(1.0)
    assert r["share_pct"] == pytest.approx(50.0)
    assert r["tflops"] == pytest.approx(494.5)
    assert r["gbps"] == pytest.approx(0.5)
    r = sc.roofline(67e9, 0.0, 4.0, "f32")
    assert r["bound"] == "fp32" and r["bound_ms"] == pytest.approx(1.0)
    assert r["share_pct"] == pytest.approx(25.0)
    r = sc.roofline(1e9, 3.35e9, 2.0, "bf16")      # 1 ms of HBM traffic
    assert r["bound"] == "HBM" and r["bound_ms"] == pytest.approx(1.0)
    r = sc.roofline(1e9, 3.35e9, None, "bf16")     # no device time
    assert r["share_pct"] is None and r["tflops"] is None


def test_increments_subtract_the_prefixes():
    rows = [{"stage": f"backbone prefix {n}", "device_ms": ms, "gflop": g,
             "min_mb": mbs, "op_mb": 2 * mbs, "out_bytes": out}
            for n, ms, g, mbs, out in (("stem+pool", 1.0, 10.0, 5.0, 4e6),
                                       ("+layer1", 3.0, 40.0, 3.0, 1e6))]
    inc = mb.increments(rows, "bf16")
    assert len(inc) == 1 and inc[0]["stage"] == "backbone stage +layer1"
    assert inc[0]["device_ms"] == 2.0 and inc[0]["gflop"] == 30.0
    # layer1 alone: the stem's 4 MB output read, then its weights and its
    # 1 MB output: 3 - 5 + 2 * 4 = 6 MB
    assert inc[0]["min_mb"] == pytest.approx(6.0)
    assert inc[0]["bound_ms"] == pytest.approx(
        max(30e9 / 989e12, 6e6 / 3.35e12) * 1e3)
    # no device time: no increment row
    assert mb.increments([dict(r, device_ms=None) for r in rows],
                         "bf16") == []


def test_tool_writes_its_record_on_the_cpu(tmp_path):
    path = tmp_path / "step.json"
    mfu = tmp_path / "mfu_inference.json"
    args = mb.parse_args(["--device", "cpu", "--batch", "2", "--iters", "1",
                          "--max-frames", str(MAXF), "--mfu", "--ckpt",
                          FIXTURE, "--width", str(WIDTH), "--channels",
                          str(CHANNELS), "--json", str(path)])
    rec = mb.run(args, mfu_path=str(mfu))
    assert [r["stage"] for r in rec["stages"]] == STAGES + [
        f"backbone prefix {label}" for _, label in mb.PREFIXES]
    assert all(r["device_ms"] is None and r["call_ms"] > 0
               and r["share_pct"] is None for r in rec["stages"])
    assert rec["vmap"].startswith("no counterpart")
    assert len(rec["chunk"]) == 4
    assert path.exists() and mfu.exists()
    k1 = {r["stage"]: r["kernel_calls"].get("K1", 0) for r in rec["stages"]}
    assert k1["offline head"] == 2 and k1["  groupdw multi (fused)"] == 1
    assert k1["FULL STEP (native batched)"] == 3
    assert rec["stages"][STAGES.index("xcorr shift (1 pair 7x7)")][
        "kernel_calls"] == {"K3": 1}


@pytest.mark.parametrize("flag", ["--s2d", "--s2b"])
def test_tpu_layout_rewrites_raise(flag):
    with pytest.raises(ValueError, match="TPU layout"):
        mb.run(mb.parse_args(["--device", "cpu", flag]))
