"""The port's training-step benchmark (`usot_tpu_torch.tools.bench_train`)
on the CPU: one iteration of each phase at the fixture's widths, end to
end through `--shards` (a synthetic shard set written on demand), and the
first naive step's loss on the trained fixture against JAX's
`make_train_step` on the same arrays (the tool's `make_batch`, the repo
tool's draws), within 1e-4."""
import numpy as np
import pytest
import torch

from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.tools import bench_train

from torch_port_common import jax_train_run, load_fixture

torch.set_num_threads(2)


def _args(tmp_path, mem_num, *extra):
    return bench_train.parse_args([
        "--device", "cpu", "--width", "8", "--channels", "32", "--batch",
        "2", "--mem-batch", "2", "--mem-num", str(mem_num), "--iters", "1",
        *extra])


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_train")
    kw, v = load_fixture()
    args = _args(tmp, kw["mem_size"], "--shards", str(tmp / "shards"))
    return bench_train.run(args, weights=state_dict_from_flax(v)), v, kw


def test_bench_train_record(fixture_run):
    rec = fixture_run[0]
    assert set(rec["phases"]) == {"naive", "cycle-memory"}
    for name, r in rec["phases"].items():
        assert {"batch", "first_step_s", "first_loss", "losses",
                "ms_per_step", "samples_per_s", "peak_memory_bytes",
                "flops_per_step", "share_of_peak", "peak"} <= set(r), name
        assert len(r["losses"]) == 4 and np.all(np.isfinite(r["losses"]))
        assert r["batch"] == 2 and r["flops_per_step"] > 0
        assert r["peak_memory_bytes"] is None  # no device memory on the CPU
        assert "FP32" in r["peak"]
    assert rec["phases"]["cycle-memory"]["flops_per_step"] > \
        rec["phases"]["naive"]["flops_per_step"]
    assert rec["kernel_launches"] == {"K1": 0, "K2": 0, "K3": 0}
    sh = rec["shards"]
    assert sh["steps"] == 4 and sh["batch"] == 2 and sh["samples_per_s"] > 0


def test_bench_train_first_loss_equals_jax(fixture_run):
    rec, v, kw = fixture_run
    batch = bench_train.make_batch(np.random.default_rng(0), 2, False,
                                   kw["mem_size"])
    want = jax_train_run(v, False, True, [batch])[0]["metrics"]["loss"]
    assert abs(rec["phases"]["naive"]["first_loss"] - want) <= 1e-4


def test_bench_train_bf16_runs(tmp_path):
    """bf16 compute over float32 weights: finite losses, the bf16 peak."""
    rec = bench_train.run(_args(tmp_path, 2, "--dtype", "bfloat16",
                                "--batch", "1", "--mem-batch", "1"))
    for r in rec["phases"].values():
        assert np.all(np.isfinite(r["losses"])) and "BF16" in r["peak"]
