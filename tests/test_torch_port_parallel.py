"""The port's data-parallel training (`usot_tpu_torch/parallel/`,
`train/step.py` with a process group) against JAX's mesh step on the CPU.

Two gloo ranks on the CPU (spawned processes that import no JAX) run
`parallel.steps.step_rank` on their rows of each global batch of 4
(`rank_rows`); JAX's `make_train_step` runs in this process under
`make_mesh(n_data=2)` on the same global batches, from the same trained
fixture weights. Under the mesh JAX's step is the single-device program
on the global batch: BN statistics and the losses' masked means span
both devices, and so must the port's.

* Synchronized train-mode BN (float64, with a gradient) and the global
  masked mean (different positive counts per rank) against one process
  on the global batch.
* One step each of naive frozen, cycle frozen, cycle unfrozen (float64
  on both sides, as `test_torch_port_train_cycle.py` holds that phase)
  and cycle frozen with accum=2, at the port's training tolerances:
  losses 1e-4 relative, BN stats 1e-4, params 1e-5, gradients 1e-3 in
  float32 (the memory branch's train-mode BN over 2-4 lanes), and 1e-6
  for all of them in float64. The two ranks' parameters are equal
  bitwise.
* With BN sync off the naive frozen step fails that check.
* A NaN on one rank skips the update on both.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (WEIGHT_DECAY, jax_train_run, load_fixture,
                               scaled_err, train_batch)
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.layers import BatchNorm
from usot_tpu_torch.parallel import mesh as port_mesh
from usot_tpu_torch.parallel.steps import one_process, run_ranks
from usot_tpu_torch.train.losses import _masked_mean

torch.set_num_threads(2)
G, M, W = 4, 2, 2

# name: (cycle, unfix, accum, float64, batch seed)
PHASES = {"naive_frozen": (False, False, 1, False, 1),
          "cycle_frozen": (True, False, 1, False, 2),
          "cycle_unfrozen": (True, True, 1, True, 3),
          "cycle_frozen_accum2": (True, False, 2, False, 4)}


def _batch(name):
    cycle, _, _, _, seed = PHASES[name]
    return train_batch(seed, G, M if cycle else None)


def _probes():
    rng = np.random.default_rng(7)
    x = rng.normal(1.5, 2.0, (G, 6, 5, 5))
    mask = np.zeros((G, 40))
    mask[0, :13] = mask[1, 5:9] = mask[3, ::3] = 1.0  # 17 : 14 positives
    return [
        dict(name="bn", kind="bn", x=x, weight=rng.uniform(0.5, 1.5, 6),
             bias=rng.normal(0, 0.1, 6), upstream=rng.normal(size=x.shape)),
        dict(name="masked_mean", kind="masked_mean",
             values=rng.uniform(0, 2, (G, 40)), mask=mask)]


def _cases():
    cases = _probes()
    for name, (cycle, unfix, accum, f64, _) in PHASES.items():
        cases.append(dict(name=name, kind="step", cycle=cycle, unfix=unfix,
                          accum=accum, sync_bn=True,
                          dtype="float64" if f64 else "float32",
                          batch=_batch(name)))
    naive = cases[2]
    cases.append({**naive, "name": "naive_frozen_nosync", "sync_bn": False})
    cases.append({**naive, "name": "naive_frozen_nan", "nan_rank": 1})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The job's cases over two gloo ranks on the CPU, and the port's
    model state before the step."""
    kw, v = load_fixture()
    state = {k: t.numpy() for k, t in state_dict_from_flax(v).items()}
    job = dict(model=kw, state=state, cases=_cases())
    ranks = run_ranks(job, ["cpu", "cpu"], "gloo",
                      str(tmp_path_factory.mktemp("ranks")))
    return dict(ranks=ranks, job=job, init=state)


@pytest.fixture(scope="module")
def jax_runs():
    _, v = load_fixture()
    return {name: jax_train_run(v, cycle, unfix, [_batch(name)],
                                accum=accum, x64=f64, mesh=W)[0]
            for name, (cycle, unfix, accum, f64, _) in PHASES.items()}


# ------------------------------------------------------------ mesh, rows

def test_rank_rows_are_jax_microbatch_shares():
    """Rule (d): each rank's local microbatch i is its share of JAX's
    contiguous microbatch i; k = 1 is P("data")'s contiguous block."""
    np.testing.assert_array_equal(port_mesh.rank_rows(8, 1, 2), [4, 5, 6, 7])
    for g, w, k in ((8, 2, 2), (12, 2, 3), (24, 4, 2), (4, 2, 2)):
        per = g // (k * w)
        rows = [port_mesh.rank_rows(g, r, w, k) for r in range(w)]
        for i in range(k):
            micro = np.concatenate([r[i * per:(i + 1) * per] for r in rows])
            np.testing.assert_array_equal(micro, np.arange(i * g // k,
                                                           (i + 1) * g // k))
    with pytest.raises(ValueError, match="divide"):
        port_mesh.rank_rows(6, 0, 2, 2)


def test_make_mesh_devices():
    """A CPU mesh is asked for; a device may repeat; without a GPU the
    default raises."""
    mesh = port_mesh.make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 3, "model": 1} and mesh.size == 3
    assert port_mesh.make_mesh(n_data=2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError):
        port_mesh.make_mesh(n_model=2, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_mesh.make_mesh()


def test_shard_batch_and_replicate_tree():
    """`shard_batch` gives P("data")'s lane blocks; `replicate_tree` one
    copy per distinct device, the module itself where it already is."""
    mesh = port_mesh.make_mesh(devices=["cpu", "cpu"])
    batch = {"a": np.arange(12.0).reshape(6, 2), "b": (torch.arange(6),)}
    blocks = port_mesh.shard_batch(mesh, batch)
    assert len(blocks) == 2
    np.testing.assert_array_equal(blocks[1]["a"].numpy(),
                                  batch["a"][3:])
    np.testing.assert_array_equal(blocks[0]["b"][0].numpy(), [0, 1, 2])
    with pytest.raises(ValueError, match="divide"):
        port_mesh.shard_batch(mesh, np.zeros((5, 2)))
    module = torch.nn.Linear(2, 2)
    replicas = port_mesh.replicate_tree(mesh, module)
    assert replicas[0] is module and replicas[1] is module
    trees = port_mesh.replicate_tree(mesh, {"w": np.ones(3)})
    assert trees[0] is trees[1] and torch.is_tensor(trees[0]["w"])


# ---------------------------------------------------------- probes

def _one(case):
    return one_process({"cases": [case]}, "cpu")[case["name"]]


def test_sync_bn_matches_global_batch(runs):
    """Train-mode BN over two ranks in float64: each rank's output and
    input gradient are the global batch's rows, the affine gradients sum
    to the global ones, and both ranks hold the global running stats."""
    case = runs["job"]["cases"][0]
    ref = _one(case)
    ranks = [r["bn"] for r in runs["ranks"]]
    for r, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
        np.testing.assert_allclose(r["y"], ref["y"][rows], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(r["x_grad"], ref["x_grad"][rows], rtol=0,
                                   atol=1e-12)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[k], ref[k], rtol=0, atol=1e-12)
    for k in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(ranks[0][k] + ranks[1][k], ref[k],
                                   rtol=0, atol=1e-10)
    # per-rank statistics would be another function of the input
    alone = BatchNorm(6).double()
    with torch.no_grad():
        alone.weight.copy_(torch.from_numpy(case["weight"]))
        alone.bias.copy_(torch.from_numpy(case["bias"]))
    y0 = alone(torch.from_numpy(case["x"][:2]), train=True)
    assert np.abs(y0.detach().numpy() - ranks[0]["y"]).max() > 1e-2


def test_global_masked_mean(runs):
    """Ranks with 17 and 14 positive cells: the mean over ranks of each
    rank's W-scaled value is the global masked mean, and the averaged
    gradient is the global one."""
    case = runs["job"]["cases"][1]
    values, mask = case["values"], case["mask"]
    want = (values * mask).sum() / mask.sum()
    got = [r["masked_mean"] for r in runs["ranks"]]
    assert mask[:2].sum() != mask[2:].sum()
    assert abs(np.mean([g["value"] for g in got]) - want) <= 1e-12
    grad = np.concatenate([g["values_grad"] for g in got]) / W
    np.testing.assert_allclose(grad, mask / mask.sum(), rtol=0, atol=1e-15)
    one = _masked_mean(torch.from_numpy(values), torch.from_numpy(mask))
    assert abs(float(one) - want) <= 1e-12


# ----------------------------------------------------------- steps

def _step_failures(rank, ref, init, f64):
    """What a rank's step misses of JAX's at the training tolerances."""
    tol = dict(loss=1e-6, stats=1e-6, params=1e-6, grads=1e-6) if f64 \
        else dict(loss=1e-4, stats=1e-4, params=1e-5, grads=1e-3)
    out = []
    for k, want in ref["metrics"].items():
        if abs(rank["metrics"][k] - want) > tol["loss"] * abs(want):
            out.append(("loss", k, rank["metrics"][k], want))
    for k, want in ref["params"].items():
        kind = "stats" if k.endswith(("running_mean", "running_var")) \
            else "params"
        err = scaled_err(rank["state"][k], want)
        if err > tol[kind]:
            out.append((kind, k, err))
    for n, g in rank["grads"].items():
        err = scaled_err(g, ref["momentum"][n] - WEIGHT_DECAY * init[n])
        if err > tol["grads"]:
            out.append(("grads", n, err))
    return out


@pytest.mark.parametrize("name", list(PHASES))
def test_step_matches_jax_mesh(runs, jax_runs, name):
    """Each rank's losses, parameters, BN running stats and gradients
    after one step equal JAX's 2-device mesh step's."""
    f64 = PHASES[name][3]
    for rank in runs["ranks"]:
        assert _step_failures(rank[name], jax_runs[name], runs["init"],
                              f64) == []


@pytest.mark.parametrize("name", list(PHASES))
def test_step_ranks_stay_equal(runs, name):
    """Both ranks hold the same parameters, BN stats and gradients,
    bitwise; the step moved the trainable parameters."""
    a, b = (r[name] for r in runs["ranks"])
    assert a["metrics"] == b["metrics"]
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], k)
    for n in a["grads"]:
        np.testing.assert_array_equal(a["grads"][n], b["grads"][n], n)
    moved = [n for n in a["grads"]
             if not np.array_equal(a["state"][n], runs["init"][n])]
    assert len(moved) > 0.9 * len(a["grads"])


def test_step_without_bn_sync_fails(runs, jax_runs):
    """The negative case: per-rank BN statistics (`sync_bn=False`) miss
    JAX's mesh step, in the BN stats among others, and the ranks drift
    apart."""
    ref = jax_runs["naive_frozen"]
    for rank in runs["ranks"]:
        failed = _step_failures(rank["naive_frozen_nosync"], ref,
                                runs["init"], False)
        assert {f[0] for f in failed} >= {"stats", "loss"}, failed
    a, b = (r["naive_frozen_nosync"] for r in runs["ranks"])
    assert any(not np.array_equal(a["state"][k], b["state"][k])
               for k in a["state"])


def test_global_gate_skips_both_ranks(runs):
    """A NaN image on rank 1 makes the global loss NaN: both ranks skip
    the update (parameters bitwise the initial ones), and both report
    the NaN loss."""
    for rank in runs["ranks"]:
        got = rank["naive_frozen_nan"]
        assert np.isnan(got["metrics"]["loss"])
        for n in got["grads"]:
            np.testing.assert_array_equal(got["state"][n], runs["init"][n],
                                          n)

