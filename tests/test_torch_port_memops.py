"""The port's ring formulations (`usot_tpu_torch.tools.bench_memops`) on
the CPU, in bfloat16 as the tool runs them.

* Bitwise: take == onehot == JAX's `take_along_axis` on the same rings;
  scatter == shared on a shared slot == JAX's `.at[lanes, slot].set`;
  with diverged slots and invalid lanes the guarded shared write is the
  scatter and JAX's scatter to the scratch slot; an invalid lane keeps
  its old content.
* The tool's correctness block passes, and fails on a shared write that
  ignores the lanes' validity.
* Bytes per frame at the bench shapes (B=32, S=257, K=5, C=256): a
  gather reads 5 x 28,160 B x 32 = 4.5 MB and writes as much, a write
  0.9 MB each way, the one-hot reads every ring.
* The record at a small size on the CPU (no device time).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usot_tpu_torch.tools import bench_memops as bm

B, S, T, K, C = 6, 9, 3, 5, 8


@pytest.fixture(scope="module")
def data():
    return bm.make_data(B, S, T, K, C)


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else
                      np.asarray(t, np.float32))


def _jax_take(ring, picks):
    idx = picks.reshape(picks.shape + (1, 1, 1))
    return jnp.take_along_axis(
        ring, jnp.broadcast_to(idx, picks.shape + ring.shape[2:]), axis=1)


def _jax_scatter(ring, f, slot, valid):
    ring_idx = jnp.where(valid, slot, S)
    return ring.at[jnp.arange(B), ring_idx].set(f[:, 0])


def _jax_rings(host):
    return [jnp.asarray(r, jnp.bfloat16) for r in host["rings"]]


def test_gathers_are_bitwise_jax_take_along_axis(data):
    d, host = data
    picks = host["picks"][0]
    want = [_jax_take(r, jnp.asarray(picks)) for r in _jax_rings(host)]
    for got in (bm.gather_take(d["rings"], d["picks"][0]),
                bm.gather_onehot(d["rings"], d["picks"][0])):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("case", ["shared", "diverged"])
def test_writes_are_bitwise_jax_scatter(data, case):
    d, host = data
    if case == "shared":
        slot, valid = d["slots"][0], d["valid"][0]
    else:
        slot, valid = d["slot_div"], d["val_mix"]
    f0 = [f[0] for f in d["feats"]]
    want = [_jax_scatter(r, jnp.asarray(f[0], jnp.bfloat16),
                         jnp.asarray(slot.numpy()), jnp.asarray(valid.numpy()))
            for r, f in zip(_jax_rings(host), host["feats"])]
    scatter = bm.write_scatter([r.clone() for r in d["rings"]], f0, slot,
                               valid)
    shared = bm.write_shared([r.clone() for r in d["rings"]], f0, slot,
                             valid, guard=True)
    for a, b, w in zip(scatter, shared, want):
        np.testing.assert_array_equal(_np(a), _np(w))
        np.testing.assert_array_equal(_np(b), _np(w))


def test_shared_write_keeps_an_invalid_lanes_slot(data):
    d, _ = data
    f0 = [f[0] for f in d["feats"]]
    slot = d["slots"][0]
    out = bm.write_shared([r.clone() for r in d["rings"]], f0, slot,
                          d["val_mix"])
    s0, keep = int(slot[0]), ~d["val_mix"]
    assert keep.any() and (~keep).any()
    for r0, w, f in zip(d["rings"], out, f0):
        assert torch.equal(w[keep, s0], r0[keep, s0])
        assert torch.equal(w[~keep, s0], f[~keep, 0])
        others = torch.ones(S + 1, dtype=torch.bool)
        others[s0] = False
        assert torch.equal(w[:, others], r0[:, others])


def test_correctness_block_passes_and_catches_a_wrong_write(data,
                                                           monkeypatch):
    d, _ = data
    bm.correctness(d)

    def ignores_validity(rings, feats, slot_b, valid_b, guard=False):
        s = slot_b[:1].long()
        for r, f in zip(rings, feats):
            r.index_copy_(1, s, f.to(r.dtype))
        return rings

    monkeypatch.setitem(bm.WRITES, "shared", ignores_validity)
    monkeypatch.setattr(bm, "write_shared", ignores_validity)
    with pytest.raises(AssertionError, match="memops"):
        bm.correctness(d)


def test_frame_loop_writes_the_frames_features(data):
    d, _ = data
    rings = [r.clone() for r in d["rings"]]
    outs = bm.frame_loop("take", "scatter", rings, d)()
    assert outs.shape == (T,)
    last = int(d["slots"][T - 1, 0])
    for r, f in zip(rings, d["feats"]):
        assert torch.equal(r[:, last], f[T - 1][:, 0])


def test_bytes_per_frame_at_the_bench_shapes():
    rings = [torch.empty((32, 258, h, w, 256), dtype=torch.bfloat16,
                         device="meta") for h, w in bm.SCALES]
    per = bm.frame_bytes(rings, 5)
    slot = 55 * 256 * 2
    assert slot == 28160
    assert per["take"] == 2 * 5 * slot * 32          # 4.5 MB each way
    assert per["scatter"] == per["shared"] == 2 * slot * 32   # 0.9 MB
    assert per["onehot"] == 32 * 258 * slot + 5 * slot * 32


def test_tool_writes_its_record_on_the_cpu(tmp_path):
    path = tmp_path / "memops.json"
    rec = bm.main(["--device", "cpu", "--batch", "2", "--slots", "9",
                   "--frames", "2", "--channels", "8", "--json", str(path)])
    assert rec["correct"] and path.exists()
    assert [(r["gather"], r["write"]) for r in rec["rows"]] == [
        ("take", "scatter"), ("take", "shared"), ("onehot", "scatter"),
        ("onehot", "shared")]
    assert all(r["ms_per_frame"] is None for r in rec["rows"])
