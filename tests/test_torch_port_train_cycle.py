"""The port's cycle-memory training (`USOTNet.forward_train` with memory
frames, `train/step.py`, `train/optim.py`) against `usot_tpu` on the CPU.

Both packages start from the trained fixture (B=2, M=2, 127/255,
`chip_smoke.training_sample` batches: a textured square on noise, so the
forward maps are peaked) and take two steps of one phase with JAX's
`make_train_step` + `build_optimizer` and the port's counterparts.

* Stages frozen: both in float32.
* Stages unfrozen (train-mode backbone BN): both in float64, and the
  port's float32 step against that. In float32 this phase is
  ill-conditioned: a 1x1 conv feeding a train-mode BN whose input has
  mean^2 / var up to ~110 (layer1) loses digits in the weight gradient,
  so the same implementation in float32 and float64 differs by 1.5-3 %
  (scale-aware) in layer1's gradients, and JAX's float32 step sits 11-15
  % from JAX's float64 one (its losses 2.5e-4, the port's 2.3e-5;
  measured on the CPU). In float64 the packages agree to ~1e-7.

Tolerances are scale-aware (`max |ours - ref| / max(max |ref|, 1)`)
unless named relative; each states the measured value it covers.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (LR, WEIGHT_DECAY, jax_train_run, load_fixture,
                               port_model, port_train_run, scaled_err,
                               train_batch)

torch.set_num_threads(2)
B, M = 2, 2


@pytest.fixture(scope="module", params=["frozen", "unfrozen"])
def phase(request):
    """Two steps of the cycle-memory phase in both packages, with the
    forward maps the argmax saw."""
    _, v = load_fixture()
    unfix = request.param == "unfrozen"
    batches = [train_batch(1, B, M), train_batch(2, B, M)]
    seen_jax, seen_port = [], []
    jax_runs = jax_train_run(v, True, unfix, batches, seen=seen_jax,
                             x64=unfix)
    port_runs, labels = port_train_run(
        v, True, unfix, batches, seen=seen_port,
        dtype=torch.float64 if unfix else None)
    f32_runs = port_train_run(v, True, unfix, batches[:1])[0] \
        if unfix else port_runs
    return dict(unfix=unfix, jax=jax_runs, port=port_runs, f32=f32_runs,
                labels=labels, seen_jax=seen_jax, seen_port=seen_port,
                init={k: t.numpy() for k, t in
                      port_model(v).state_dict().items()})


def _stat_keys(state):
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def _held(phase, tol_f32, tol_f64):
    """(port runs, tolerance) to hold against JAX's: the float32 step, and
    when unfrozen also the float64 one."""
    return [(phase["f32"], tol_f32)] + (
        [(phase["port"], tol_f64)] if phase["unfix"] else [])


def test_forward_train_losses(phase):
    """The three losses within 1e-4 relative: measured 2.8e-7 (frozen,
    f32), 4.0e-6 (unfrozen, port f32 against JAX f64) and 1e-7 (f64)."""
    ref = phase["jax"][0]["metrics"]
    for runs, tol in _held(phase, 1e-4, 1e-6):
        got = runs[0]["metrics"]
        assert got["cls_loss_memory"] > 0
        for k in ("cls_loss_ori", "cls_loss_memory", "reg_loss", "loss"):
            assert abs(got[k] - ref[k]) <= tol * abs(ref[k]), (k, got, ref)


def test_forward_train_argmax_cells(phase):
    """The cycle branch's argmax picks the same cell in every memory
    frame, on maps whose top-2 gap (>= 5.5e-3 measured) is far above the
    packages' gap on them (1.1e-5 f32, 6e-8 f64)."""
    ref, got = phase["seen_jax"][0], phase["seen_port"][0]
    assert ref.shape == got.shape == (B, M, 25 * 25)
    np.testing.assert_array_equal(got.argmax(2), ref.argmax(2))
    top2 = np.sort(ref, axis=2)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    err = float(np.abs(got - ref).max())
    assert gap > 100 * err, (gap, err)


def test_forward_train_bn_stats(phase):
    """BN running stats after the step (flax's `mutated["batch_stats"]`)
    within 1e-4: measured 2.3e-6 (frozen), 1.0e-5 (unfrozen, port f32 vs
    JAX f64), 5e-8 (f64). The neck and head stats moved, and the stages'
    too once unfrozen; the stem's never."""
    ref = phase["jax"][0]["params"]
    for runs, tol in _held(phase, 1e-4, 1e-6):
        got = runs[0]["params"]
        for k in _stat_keys(ref):
            assert scaled_err(got[k], ref[k]) <= tol, k
    init, got = phase["init"], phase["port"][0]["params"]
    moved = {k for k in _stat_keys(ref) if not np.array_equal(got[k],
                                                               init[k])}
    assert {k for k in _stat_keys(ref)
            if not k.startswith("features.")} <= moved
    stages = {k for k in _stat_keys(ref)
              if k.startswith("features.features.layer")}
    assert (stages <= moved) if phase["unfix"] else not (stages & moved)
    assert not any(k.startswith("features.features.bn1") for k in moved)


def test_step_gradients(phase):
    """Per-tensor gradients against JAX's (its first-step trace less the
    weight decay): 1e-3 frozen (measured 1.5e-4, the memory branch's
    train-mode BN over 2-4 lanes), 1e-6 unfrozen in f64 (measured
    1e-7). The trainable set is the optimizer's."""
    tol = 1e-6 if phase["unfix"] else 1e-3
    init, ref = phase["init"], phase["jax"][0]["momentum"]
    grads = phase["port"][0]["grads"]
    assert set(grads) == {n for n, label in phase["labels"].items()
                          if label != "frozen"}
    for n, g in grads.items():
        want = ref[n] - WEIGHT_DECAY * init[n]
        assert scaled_err(g, want) <= tol, n


def test_step_params(phase):
    """Params after the update within 1e-5 (measured 7.7e-7 frozen, 6e-8
    f64); frozen params bitwise unchanged after both steps."""
    ref, got = phase["jax"][0]["params"], phase["port"][0]["params"]
    for n, label in phase["labels"].items():
        assert scaled_err(got[n], ref[n]) <= 1e-5, n
        if label == "frozen":
            assert np.array_equal(phase["port"][1]["params"][n],
                                  phase["init"][n]), n
    moved = [n for n in phase["port"][0]["grads"]
             if not np.array_equal(got[n], phase["init"][n])]
    assert len(moved) > 0.9 * len(phase["port"][0]["grads"])


def test_momentum_two_steps(phase):
    """torch's momentum buffers equal optax's trace after each of two
    steps (torch seeds the buffer with the first gradient, optax adds it
    to zero): 2e-3 frozen (measured 6.3e-4 on the second step), 1e-6 in
    f64 (measured 1e-7)."""
    tol = 1e-6 if phase["unfix"] else 2e-3
    for got, ref in zip(phase["port"], phase["jax"]):
        assert set(got["momentum"]) == set(phase["port"][0]["grads"])
        for n, buf in got["momentum"].items():
            assert scaled_err(buf, ref["momentum"][n]) <= tol, n
    # a second step at the same LR moved every trainable parameter again
    assert LR > 0 and any(
        not np.array_equal(phase["port"][1]["params"][n],
                           phase["port"][0]["params"][n])
        for n in phase["port"][0]["grads"])


def test_remat_matches_plain_step():
    """`remat`: `torch.utils.checkpoint` recomputes the forward, train-mode
    BNs included, in backward; the running stats must update once, as
    under `jax.checkpoint`. Unfrozen cycle-memory step on the CPU: grads,
    params and losses equal the plain step's, BN stats bitwise."""
    _, v = load_fixture()
    batches = [train_batch(3, B, M)]
    plain = port_train_run(v, True, True, batches)[0]
    remat = port_train_run(v, True, True, batches, remat=True)[0]
    assert remat[0]["metrics"] == plain[0]["metrics"]
    for n, g in plain[0]["grads"].items():
        assert scaled_err(remat[0]["grads"][n], g) <= 1e-6, n
        assert scaled_err(remat[0]["params"][n], plain[0]["params"][n]) \
            <= 1e-6, n
    for k in _stat_keys(plain[0]["params"]):
        assert np.array_equal(remat[0]["params"][k], plain[0]["params"][k]), k
