"""The B=16 free-running batch engine on seeded full-width random weights,
the port's against JAX's on the CPU: the same lanes go non-finite at
the same step (or neither does).

On the card the port's B=16 engine (phase 15 of `chip_smoke.py`, its
video and init) goes non-finite on every lane at step 24 of random
weights, its B=32 engine not. This holds the port's postprocess and
carry against JAX's on the same weights and frames: `chip_smoke.
build_model`'s weights (width 64, channels 256, queue 7, BN stats
calibrated on the CPU) saved as `.pth` and read by JAX's
`load_variables`, 40 frame steps of `synthetic_video` at 480x640, chunk
40, both packages' init crops the port's `get_subwindow`.

Measured on the CPU: both packages go non-finite at step 0 on every
lane. Random weights put the bbox head's exp at f32's overflow edge
(~2e38 of 3.4e38), so whether and when a lane overflows is decided by
the last bits of the convolutions: on the CPU at the first step in both
packages, on the card at step 24 at B=16 and never at B=32.

Marked slow: a full-width B=16 engine takes minutes on the CPU in each
package (JAX's includes its compile).
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.tracker.engine import BatchScanEngine, synthetic_video
from usot_tpu_torch.tracker.runner import ModelRunner

CPU = torch.device("cpu")
BATCH, STEPS, H, W = 16, 40, 480, 640


def _first_nonfinite(pos, sz):
    """Per lane, the first frame step whose box is not finite (-1: none)."""
    bad = ~(np.isfinite(pos).all(-1) & np.isfinite(sz).all(-1))
    return [int(np.argmax(row)) if row.any() else -1 for row in bad]


@pytest.mark.slow
def test_b16_nonfinite_lanes_match_jax(tmp_path):
    import usot_tpu.tracker.engine as jax_engine
    from usot_tpu.models.usot import build_usot as jax_build
    from usot_tpu.tracker.config import TrackerConfig as JaxConfig
    from usot_tpu.tracker.runner import ModelRunner as JaxRunner
    from usot_tpu.train.checkpoint import load_variables

    torch.manual_seed(0)
    model = chip_smoke.build_model(CPU)
    pth = os.path.join(tmp_path, "random_full_width.pth")
    torch.save({"state_dict": model.state_dict()}, pth)

    frames = synthetic_video(STEPS + 1, h=H, w=W)
    videos = [(frames[0], np.array([200.0, 240.0]),
               np.array([60.0, 60.0]))] * BATCH
    stack = np.broadcast_to(np.stack(frames[1:])[None],
                            (BATCH, STEPS, H, W, 3))
    n_valid = np.full(BATCH, STEPS)

    p = chip_smoke._tracker_config("small")
    eng = BatchScanEngine(model, p, H, W, batch=BATCH, max_frames=64,
                          chunk=STEPS, device=CPU)
    _, pos, sz, _ = eng.track_batch(
        eng.init_batch(videos, ModelRunner(model, device=CPU)), stack,
        n_valid)

    jp = JaxConfig()
    jp.instance_size = jp.small_sz
    jp.renew()
    jp.sf_size = jp.score_size
    jm = jax_build(mem_size=7, width=64, channels=256)
    v = load_variables(pth)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "get_subwindow", get_subwindow)
        j_eng = jax_engine.BatchScanEngine(jm, v, jp, H, W, batch=BATCH,
                                           max_frames=64, chunk=STEPS,
                                           impl="native")
        _, j_pos, j_sz, _ = j_eng.track_batch(
            j_eng.init_batch(videos, JaxRunner(jm, v)), stack, n_valid)

    ours = _first_nonfinite(pos, sz)
    want = _first_nonfinite(np.asarray(j_pos), np.asarray(j_sz))
    print("first non-finite step per lane: port", ours, "jax", want)
    assert ours == want
