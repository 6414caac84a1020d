"""Port BN calibration against `usot_tpu.models.calibrate`.

Both packages start from the same random weights (BN stats at flax's
init, mean 0 and var 1) and run two calibration passes on the same
seeded inputs. This pins flax's update rule (0.9 * old + 0.1 * batch,
biased variance) in the port, which torch's BatchNorm2d does not follow.

Tolerances, per tensor and scale-aware. Backbone and neck stats: 1e-4,
against the same passes replayed in f64 by the port and against JAX.
Head stats: train-mode BN on the 5x5 kernel encodings amplifies f32
rounding. Measured on two seeds, the port's f32 sits up to 1.0e-4 from
the f64 replay (held at 3e-4) and the JAX f32 passes up to 4.8e-4 (so
port against JAX is held at 1e-3).
"""
import numpy as np
import torch

from usot_tpu.models.calibrate import calibrate_batch_stats as jax_calibrate
from usot_tpu.models.usot import build_usot as jax_build
from usot_tpu_torch.models.calibrate import calibrate_batch_stats
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.usot import build_usot

from torch_port_common import CHANNELS, WIDTH, random_variables

# Several test workers share the host's cores; tiny shapes need few threads.
torch.set_num_threads(2)


def _close(ours, ref, tol, key):
    ours, ref = ours.double().numpy(), ref.double().numpy()
    atol = tol * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol, err_msg=key)


def test_calibration_matches_jax():
    jm = jax_build(mem_size=2, width=WIDTH, channels=CHANNELS)
    v0 = random_variables(5, bn_stats=False)
    ref = state_dict_from_flax(jax_calibrate(jm, v0, seed=1, n_iter=2))

    models = []
    for dtype in (torch.float32, torch.float64):
        pm = build_usot(mem_size=2, width=WIDTH, channels=CHANNELS)
        pm.load_state_dict(state_dict_from_flax(v0))
        models.append(calibrate_batch_stats(pm.to(dtype), seed=1, n_iter=2))
    state, exact = (m.state_dict() for m in models)

    stat_keys = [k for k in ref if k.endswith(("running_mean",
                                                "running_var"))]
    # stem, 13 bottlenecks x 3 + 3 downsamples, neck, 12 encoders,
    # ConfFusion's 2, 3 towers x 4
    assert len(stat_keys) == 2 * (1 + 3 * 13 + 3 + 1 + 12 + 2 + 12)
    for k in stat_keys:
        head = k.startswith("connect_model.")
        _close(state[k], exact[k], 3e-4 if head else 1e-4, k)
        _close(state[k], ref[k], 1e-3 if head else 1e-4, k)
        # every BN saw train-mode batches
        assert not torch.allclose(ref[k], torch.zeros_like(ref[k])
                                  if k.endswith("mean")
                                  else torch.ones_like(ref[k])), k
    for k in ref:
        if k not in stat_keys:  # parameters are untouched
            assert torch.equal(state[k], ref[k]), k
