"""The port's `entry()` against the repo's JAX `entry()` fn, and the
profiling helpers (`utils/profiling.py`) against `usot_tpu`'s.

`entry()`'s fn runs the flagship model at full width; both packages get
JAX's variables (the port's through `state_dict_from_flax`) and the same
seeded inputs, compared at scale-aware 1e-4 on the cells finite in both
(fresh BN statistics overflow the bbox `exp` on image-range input).
"""
import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import usot_tpu.utils.profiling as jax_profiling
from usot_tpu_torch import entry as port_entry
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.utils import profiling

from torch_port_common import scaled_err

torch.set_num_threads(4)


def test_entry_matches_jax():
    jfn, (variables, x, zf, mem) = graft.entry()
    fn, (model, px, pzf, pmem) = port_entry.entry(device="cpu")
    assert (tuple(px.shape), tuple(pzf.shape), tuple(pmem.shape)) == \
        (x.shape, zf.shape, mem.shape)
    assert px.device.type == "cpu" and model.connect_model is not None
    model.load_state_dict(state_dict_from_flax(variables))
    model.cast_weights()
    rng = np.random.default_rng(0)
    x = (rng.random(x.shape) * 255).astype(np.float32)
    zf = rng.normal(0, 1, zf.shape).astype(np.float32)
    mem = rng.normal(0, 1, mem.shape).astype(np.float32)
    want = jfn(variables, x, zf, mem)
    ours = fn(model, torch.from_numpy(x), torch.from_numpy(zf),
              torch.from_numpy(mem))
    assert [tuple(o.shape) for o in ours] == [
        (1, 25, 25, 1), (1, 25, 25, 4), (1, 25, 25, 1), (1, 31, 31, 256)]
    for name, o, w in zip(("cls", "bbox", "cls_mem", "xf"), ours, want):
        o, w = o.numpy(), np.asarray(w)
        assert o.shape == w.shape, name
        np.testing.assert_array_equal(np.isfinite(o), np.isfinite(w), name)
        keep = np.isfinite(w)
        assert keep.mean() > 0.5, name
        err = scaled_err(o[keep], w[keep])
        assert err <= 1e-4, (name, err)


def test_entry_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()


def test_fps_meter_equals_jax(monkeypatch):
    meters = {}
    for mod in (jax_profiling, profiling):
        ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        monkeypatch.setattr(mod.time, "perf_counter", lambda t=ticks: next(t))
        m = mod.FPSMeter()
        assert m.fps == 0.0
        for n in (1, 4, 2):
            m.tic()
            m.toc(n)
        meters[mod.__name__] = (m.total, m.frames, m.fps)
        monkeypatch.undo()
    assert meters["usot_tpu.utils.profiling"] == \
        meters["usot_tpu_torch.utils.profiling"] == (0.875, 7, 8.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_dryrun_multichip_gives_a_finite_loss(capfd):
    """`dryrun_multichip(2, device="cpu")`: one data-parallel cycle-memory
    step over two gloo ranks on the CPU, JAX's tiny geometry at full
    width. Its loss is finite and equals the same step in one process on
    the global batch within 1e-5 relative."""
    loss = port_entry.dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): loss=" in capfd.readouterr().out
    one = port_entry._dryrun_loss(2, torch.device("cpu"))
    assert abs(loss - one) <= 1e-5 * abs(one), (loss, one)


def test_dryrun_multichip_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(2)
