"""The port's bfloat16 training step against JAX's in the unfrozen
phases (naive and cycle memory, the stages' BN in train mode), as
`test_torch_port_train_bf16.py` holds the frozen ones.

The first step's BN running stats are held at half of JAX's own
bf16-vs-f32 gap. The rest is held by accuracy, the port's gap to JAX's
float32 at most 1.25x JAX's bf16 gap to it, and the first-step
gradients also by direction: over each trainable stage, their cosine to
JAX's float32 gradients at least half JAX's bf16 ones' (a gap limit of
~1.5 alone would pass a zero gradient, whose relative RMS is 1). The
unfrozen phase is
ill-conditioned (a 1x1 convolution into a train-mode BN whose input has
mean^2/var ~100; its float32 gradients are held in float64 in
`test_torch_port_train_cycle.py`). A bf16 ulp that the two packages'
convolutions round apart comes out of that BN ~10x larger, so two bf16
implementations differ as much as either differs from float32: JAX's
bf16 and f32 first-step gradients are ~1.2 apart (relative RMS), and the
naive phase's first-step losses 1.2e-2, where the port's are 2.9e-2 from
JAX's bf16 but 1.6e-2 from JAX's f32 over both steps (JAX's bf16:
2.1e-2).
"""
import pytest
import torch

from torch_port_common import (bf16_step_views, finish_jax_runs,
                               load_fixture, port_model, port_train_run,
                               rel_rms, stage_cosines, start_jax_runs,
                               train_batch)

torch.set_num_threads(2)
CASES = {"naive_unfrozen": (False, True, (1, 2), 2, None, 1),
         "cycle_unfrozen": (True, True, (3, 4), 2, 2, 1)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_bf16_unfrozen") / "runs.pkl"
    proc = start_jax_runs(path, CASES)
    try:
        yield lambda: finish_jax_runs(proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_unfrozen_step_matches_jax(jax_runs, case):
    cycle, unfix, seeds, b, mem, accum = CASES[case]
    _, v = load_fixture()
    batches = [train_batch(s, b, mem) for s in seeds]
    port, labels = port_train_run(v, cycle, unfix, batches,
                                  compute=torch.bfloat16)
    runs = jax_runs()[case]
    init = {k: t.numpy() for k, t in port_model(v).state_dict().items()}
    ours, bf, f32 = (bf16_step_views(r, labels, init)
                     for r in (port, runs[True], runs[False]))
    n_stats = len(ours["stats"]) // len(port)
    mine = rel_rms(ours["stats"][:n_stats], bf["stats"][:n_stats])
    own = rel_rms(f32["stats"][:n_stats], bf["stats"][:n_stats])
    print(f"{case} first-step stats: port vs JAX bf16 {mine:.3e}, JAX f32 "
          f"vs bf16 {own:.3e}")
    held = [("first-step stats", mine, 0.5 * own)]
    for part in ("losses", "stats", "params", "grads"):
        mine, own = rel_rms(ours[part], f32[part]), rel_rms(bf[part],
                                                            f32[part])
        print(f"{case} {part}: port bf16 vs JAX f32 {mine:.3e}, JAX bf16 "
              f"vs f32 {own:.3e}")
        held.append((part, mine, 1.25 * own))
    cos = stage_cosines(ours["grads"], f32["grads"], labels)
    own = stage_cosines(bf["grads"], f32["grads"], labels)
    print(f"{case} gradient cosines to JAX f32: port bf16 {cos}, JAX bf16 "
          f"{own}")
    assert all(mine <= limit for _, mine, limit in held), held
    assert set(cos) == {"connect_model", "neck"} | {
        f"features.features.layer{i}" for i in (1, 2, 3)}
    assert all(cos[s] >= 0.5 * own[s] for s in cos), (cos, own)
