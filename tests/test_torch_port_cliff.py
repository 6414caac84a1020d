"""The port's cliff tools (`usot_tpu_torch.tools.cliff_sweep` and
`cliff_bisect`) on the CPU.

* Every sweep stage's output at B=2 against what the JAX tool
  (`tools/cliff_sweep.py`) calls for it, on the same numpy inputs and the
  trained fixture, in float32, within the scale-aware 1e-4 of
  `tests/test_reference_parity.py:34-39`.
* Chains A-E's readouts against the JAX tool's chain expressions
  (`tools/cliff_bisect.py:80-116`) on JAX's unfused model, at the same
  tolerance; chain F (every correlation through K1's route) equals chain
  E.
* The cliff test itself: each stage's operations and bound bytes per
  sample are the same at B=1, 2 and 3.
* The tools' records at B=2 on the CPU, a `torch.profiler` trace per
  stage (`--trace`, in place of JAX's `--hlo`), unknown stages and chains
  refused.
"""
import json
import os

import numpy as np
import pytest
import torch

from usot_tpu_torch.tools import cliff_bisect as cb
from usot_tpu_torch.tools import cliff_sweep as cs
from usot_tpu_torch.tools import microbench_step as mb
from usot_tpu_torch.tools import stage_cost as sc
from usot_tpu_torch.tracker.engine import BatchScanEngine

from torch_port_common import (CHANNELS, FIXTURE, WIDTH, jax_step_refs,
                               leaves, scaled_err, step_setup)

torch.set_num_threads(2)
B, MAXF = 2, 48
# the sweep's stages -> the JAX reference of the same computation
REF = {"full": "FULL STEP (native batched)",
       "memhead": "ENC offline+memory head",
       "enc_search": "  encode_search (6 convs)", "xcorr_pair": "xcorr_pair",
       "groupdw": "  groupdw multi (fused)",
       "conf": "  conf_fusion (B*M maps)", "towers": "towers",
       "backbone": "backbone+neck"}


def _engine(model, b):
    return BatchScanEngine(model, mb.tracker_config(), mb.H, mb.W, batch=b,
                           max_frames=MAXF, chunk=8, device="cpu")


@pytest.fixture(scope="module")
def setup():
    return step_setup(B, MAXF)


@pytest.fixture(scope="module")
def refs(setup):
    from usot_tpu.tracker.config import TrackerConfig as JaxConfig

    jp = JaxConfig()
    jp.instance_size = jp.small_sz
    jp.renew()
    jp.sf_size = jp.score_size
    return jax_step_refs(setup.jm, setup.v, setup.inp, jp)


@pytest.mark.parametrize("name", cs.ALL_STAGES)
def test_sweep_stage_equals_the_jax_tools(setup, refs, name):
    with torch.inference_mode():
        fn = cs.stage_fns(setup.fused, _engine(setup.fused, B), setup.t)[name]
        got = leaves(fn())
    want = leaves(refs[REF[name]]())
    if name == "towers":
        got = [np.transpose(a, (0, 2, 3, 1)) for a in got]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape, (name, a.shape, w.shape)
        assert scaled_err(a, w) <= 1e-4, (name, scaled_err(a, w))


def _jax_chains(jm, v, inp):
    """The JAX tool's chains A-E (`tools/cliff_bisect.py:80-107`) on the
    inputs: {chain: readout}."""
    import jax.numpy as jnp

    from usot_tpu.models.usot import USOTNet

    xf = jnp.asarray(inp["xf"])
    zf_enc = jm.apply(v, jnp.asarray(inp["zf"]),
                      method=USOTNet.encode_template)
    queue_enc = tuple(jnp.asarray(q) for q in inp["queue_enc"])

    def mean(*ts):
        return sum(jnp.mean(t.astype(jnp.float32)) for t in ts)

    def a(m, xf_t, zf_enc, queue_enc):
        cx = m.connect.cls_encode_s(xf_t, False)
        rx = m.connect.reg_encode_s(xf_t, False)
        return mean(*cx, *rx)

    def b(m, xf_t, zf_enc, queue_enc):
        cx = m.connect.cls_encode_s(xf_t, False)
        rx = m.connect.reg_encode_s(xf_t, False)
        return mean(m.connect.cls_dw(list(zf_enc[0]), cx),
                    m.connect.reg_dw(list(zf_enc[1]), rx))

    def c(m, xf_t, zf_enc, queue_enc):
        bbox, cls, _, _ = m.connect.offline_preenc(
            xf_t, list(zf_enc[0]), list(zf_enc[1]))
        return mean(cls, bbox)

    def d(m, xf_t, zf_enc, queue_enc):
        bbox, cls, cls_x, _ = m.connect.offline_preenc(
            xf_t, list(zf_enc[0]), list(zf_enc[1]))
        bq, n_q = queue_enc[0].shape[0], queue_enc[0].shape[1]
        flat = [q.reshape((bq * n_q,) + q.shape[2:]) for q in queue_enc]
        return mean(cls, bbox, m.connect.cls_dw.multi(flat, cls_x, n_q))

    def e(m, xf_t, zf_enc, queue_enc):
        cls, bbox, cls_mem = m.track_memory_encoded_batched(
            xf_t, zf_enc, queue_enc)
        return mean(cls, cls_mem, bbox)

    return {k: float(jm.apply(v, xf, zf_enc, queue_enc, method=f))
            for k, f in zip("ABCDE", (a, b, c, d, e))}


@pytest.fixture(scope="module")
def chains(setup):
    with torch.inference_mode():
        fns = cb.chain_fns(setup.plain, setup.fused, setup.t)
        ours = {k: float(fn()) for k, fn in fns.items()}
    return ours, _jax_chains(setup.jm, setup.v, setup.inp)


@pytest.mark.parametrize("chain", "ABCDE")
def test_chain_equals_the_jax_tools(chains, chain):
    ours, want = chains
    assert abs(ours[chain] - want[chain]) <= 1e-4 * max(abs(want[chain]),
                                                        1.0)


def test_chain_f_equals_chain_e(chains):
    ours, _ = chains
    assert abs(ours["F"] - ours["E"]) <= 1e-4 * max(abs(ours["E"]), 1.0)


@pytest.fixture(scope="module")
def per_sample():
    """{stage: [(operations, bound bytes) per sample at B=1, 2, 3]}."""
    out = {}
    for b in (1, 2, 3):
        s = step_setup(b, MAXF)
        with torch.inference_mode():
            fns = cs.stage_fns(s.fused, _engine(s.fused, b), s.t)
            for name, fn in fns.items():
                c = sc.stage_counts(fn)
                out.setdefault(name, []).append(
                    ((c["aten_flops"] + c["kernel_flops"]) / b,
                     c["min_bytes"] / b))
    return out


@pytest.mark.parametrize("name", cs.ALL_STAGES)
def test_per_sample_counts_are_flat(per_sample, name):
    """The cliff test's premise: the work per sample does not grow with
    the batch (the bytes shed the weights' share, read once per batch)."""
    (f1, b1), (f2, b2), (f3, b3) = per_sample[name]
    assert f1 == pytest.approx(f2, rel=1e-12) == pytest.approx(f3,
                                                               rel=1e-12)
    assert b1 >= b2 >= b3 > 0


def test_sweep_tool_writes_records_and_traces(tmp_path):
    args = cs.parse_args(["--device", "cpu", "--batch", "2", "--iters", "1",
                          "--stages", "xcorr_pair,towers", "--ckpt",
                          FIXTURE, "--width", str(WIDTH), "--channels",
                          str(CHANNELS), "--json",
                          str(tmp_path / "cliff.json"), "--trace",
                          str(tmp_path / "trace")])
    rec = cs.run(args)
    assert [r["stage"] for r in rec["stages"]] == ["xcorr_pair", "towers"]
    assert rec["stages"][0]["kernel_calls"] == {"K1": 1}
    for r in rec["stages"]:
        assert r["device_ms"] is None and r["call_ms"] > 0
        with open(r["trace"]) as f:
            assert json.load(f)["traceEvents"]
    assert os.path.exists(tmp_path / "cliff.json")
    with pytest.raises(ValueError, match="unknown stages"):
        cs.run(cs.parse_args(["--device", "cpu", "--stages", "nope"]))


def test_bisect_tool_writes_its_record(tmp_path):
    args = cb.parse_args(["--device", "cpu", "--batch", "2", "--iters", "1",
                          "--chains", "B,F", "--ckpt", FIXTURE, "--width",
                          str(WIDTH), "--channels", str(CHANNELS), "--json",
                          str(tmp_path / "bisect.json")])
    rec = cb.run(args)
    b_, f_ = rec["chains"]
    assert (b_["stage"], f_["stage"]) == ("chain B", "chain F")
    # B's pair correlations are the grouped convolution; F's go to K1
    assert "K1" not in b_["kernel_calls"] and f_["kernel_calls"] == {"K1": 3}
    assert np.isfinite(b_["readout"]) and np.isfinite(f_["readout"])
    with pytest.raises(ValueError, match="unknown chains"):
        cb.run(cb.parse_args(["--device", "cpu", "--chains", "G"]))
