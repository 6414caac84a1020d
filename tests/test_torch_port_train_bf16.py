"""The port's bfloat16 training step against JAX's bfloat16 step, from the
trained fixture's weights (w8c32, 2 memory frames, B=2), two steps per
phase: the frozen naive and cycle-memory phases, accum=2, remat.

Held as the inference path is (`test_torch_port_bf16.py`): the port's
relative RMS gap to JAX's bf16 at most half of JAX's own bf16-vs-f32
gap, for the losses, the BN running stats, the first step's gradients
and the parameters after each step. JAX's steps run jitted with XLA's
excess precision off, so each bf16 op rounds as written (see
`torch_port_common.start_jax_runs`). The unfrozen phases are
`test_torch_port_train_bf16_unfrozen.py`'s.
"""
import numpy as np
import pytest
import torch

from torch_port_common import (WEIGHT_DECAY, bf16_step_views,
                               finish_jax_runs, load_fixture, port_model,
                               port_train_run, rel_rms, start_jax_runs,
                               train_batch)

torch.set_num_threads(2)
BF16 = torch.bfloat16
# key: (cycle, unfix, batch seeds, batch, memory frames, accum)
CASES = {"naive": (False, False, (1, 2), 2, None, 1),
         "cycle": (True, False, (3, 4), 2, 2, 1),
         "naive_accum2": (False, False, (5, 6), 4, None, 2)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_bf16") / "runs.pkl"
    proc = start_jax_runs(path, CASES)
    try:
        yield lambda: finish_jax_runs(proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _port(case, **kw):
    cycle, unfix, seeds, b, mem, accum = CASES[case]
    _, v = load_fixture()
    batches = [train_batch(s, b, mem) for s in seeds]
    return port_train_run(v, cycle, unfix, batches, accum=accum,
                          compute=BF16, **kw)


def hold(case, port, labels, jax_f32, jax_bf16, parts=("losses", "stats",
                                                       "params", "grads")):
    _, v = load_fixture()
    init = {k: t.numpy() for k, t in port_model(v).state_dict().items()}
    ours = bf16_step_views(port, labels, init)
    bf = bf16_step_views(jax_bf16, labels, init)
    f32 = bf16_step_views(jax_f32, labels, init)
    for part in parts:
        mine, own = rel_rms(ours[part], bf[part]), rel_rms(f32[part],
                                                           bf[part])
        print(f"{case} {part}: port vs JAX bf16 {mine:.3e}, JAX f32 vs "
              f"bf16 {own:.3e}")
        assert mine <= 0.5 * own, (case, part, mine, own)


@pytest.mark.parametrize("case", ["naive", "cycle", "naive_accum2"])
def test_bf16_step_matches_jax(jax_runs, case):
    port, labels = _port(case)
    runs = jax_runs()[case]
    hold(case, port, labels, runs[False], runs[True])


def test_bf16_step_keeps_float32_state():
    """Parameters, BN statistics, gradients and momentum stay float32; the
    frozen stages do not move."""
    port, labels = _port("cycle")
    _, v = load_fixture()
    init = {k: t.numpy() for k, t in port_model(v).state_dict().items()}
    last = port[-1]
    state = {k: a for k, a in last["params"].items()
             if not k.endswith("num_batches_tracked")}
    for group in (state, last["grads"], last["momentum"]):
        assert all(a.dtype == np.float32 for a in group.values())
    for n, label in labels.items():
        if label == "frozen":
            assert np.array_equal(last["params"][n], init[n]), n


def test_bf16_remat_is_the_plain_step():
    """remat recomputes the backbone's blocks in bf16 with the same
    rounding: losses, gradients, stats and parameters equal the plain
    step's."""
    plain, _ = _port("cycle")
    remat, _ = _port("cycle", remat=True)
    for a, b in zip(plain, remat):
        assert a["metrics"] == b["metrics"]
        for group in ("params", "grads"):
            for k in a[group]:
                assert np.array_equal(a[group][k], b[group][k]), (group, k)


def test_unfreeze_drops_the_cached_casts():
    """A frozen parameter's bf16 copy is cast once and kept
    (`models.layers.derived`); once the stages are unfrozen the copy is
    cast from the parameter at every call, so the step after the
    unfreeze sees the updated weights: a layer1 convolution's output
    equals the one computed from its weight cast afresh."""
    from usot_tpu_torch.models.layers import cast_param
    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    _, v = load_fixture()
    model = port_model(v, compute=BF16)
    conv = model.features.features.layer1[0].conv1
    opt, _ = build_optimizer(model, 0.9, WEIGHT_DECAY, 0.1, False)
    step = make_train_step(model, opt, False, False, 0.3)
    batch = {k: torch.from_numpy(a) for k, a in train_batch(1, 2).items()}
    step(batch, 0.005, 0.5)
    frozen = cast_param(conv, "weight", BF16)
    assert frozen is cast_param(conv, "weight", BF16)  # kept
    opt, _ = build_optimizer(model, 0.9, WEIGHT_DECAY, 0.1, True)
    step = make_train_step(model, opt, False, True, 0.3)
    step(batch, 0.005, 0.5)
    step(batch, 0.005, 0.5)
    assert not torch.equal(conv.weight.detach().to(BF16), frozen)
    x = torch.randn(1, conv.in_channels, 9, 9).to(BF16)
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x, conv.weight.to(BF16))
        assert torch.equal(conv(x), want)
