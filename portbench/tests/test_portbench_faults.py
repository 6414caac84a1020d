"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the CPU at small widths), the
rest of the run is the cell's own. Faults: answers altered where the
program produces them (tracking: `portbench/faults.py`'s, among them
faults on every frame's size or score and on the first frame of each
chunk alone); a step that leaves the state unchanged, and half of the
batch left out with the mean over the rest (training). Each is held to
the cell's own limits; the sound run at the same size reads at least
ten times lower."""
import numpy as np
import pytest
import torch

from conftest import small_context
from portbench import faults, harness


def readings(line):
    return {k: v["value"] for k, v in line["checks"].items()}


# Staged traffic whose chunks are long enough that the first frame of
# each is one frame in 16, and whose targets are large enough that a
# tenth of a box's size is several pixels.
LONG_CHUNKS = dict(canvas=[240, 320], box_px=[60, 100], frames_per_video=33,
                   chunk=16, max_frames=40)


def sound_and_broken(cell, monkeypatch, patch, config=None, traffic=None):
    bench, ctx = small_context(cell, config=config, traffic=traffic)
    sound = harness.run_cell(ctx, bench)
    with monkeypatch.context() as m:
        patch(m)
        bench, ctx = small_context(cell, config=config, traffic=traffic)
        broken = harness.run_cell(ctx, bench)
    return sound, broken


def assert_caught(sound, broken):
    assert not broken["correct"]
    s, b = readings(sound), readings(broken)
    assert any(b[k] >= 10 * max(s[k], 1e-12) and b[k] > lim
               for k, lim in ((k, v["limit"])
                              for k, v in broken["checks"].items()))


def test_engine_answer_altered(monkeypatch):
    sound, broken = sound_and_broken(
        "track_b64_staged", monkeypatch, faults.answer_altered,
        config={"dtype": "float32"})
    assert_caught(sound, broken)


@pytest.mark.parametrize("fault", ["size_scaled", "score_shifted",
                                   "chunk_lanes_rolled"])
def test_engine_fault_caught(fault, monkeypatch):
    sound, broken = sound_and_broken(
        "track_b64_staged", monkeypatch, faults.TRACKING[fault],
        config={"dtype": "float32"}, traffic=LONG_CHUNKS)
    assert_caught(sound, broken)


def test_tracker_answer_altered(monkeypatch):
    from usot_tpu_torch.tracker.tracker import USOTTracker

    real = USOTTracker.track

    def altered(self, state, im):
        state = real(self, state, im)
        state["target_pos"] = state["target_pos"] + [12.0, 0.0]
        return state
    sound, broken = sound_and_broken(
        "track_b1_live", monkeypatch,
        lambda m: m.setattr(USOTTracker, "track", altered),
        config={"dtype": "float32"})
    assert_caught(sound, broken)


def test_training_state_unchanged(monkeypatch):
    sound, broken = sound_and_broken(
        "train_cycle_b12", monkeypatch,
        lambda m: m.setattr(torch.optim.SGD, "step",
                            lambda self, closure=None: None))
    assert readings(broken)["change"] == pytest.approx(1.0)
    assert_caught(sound, broken)


def test_training_half_batch(monkeypatch):
    import usot_tpu_torch.train.step as steps

    real = steps.make_train_step

    def halved(*a, **k):
        step = real(*a, **k)

        def half(batch, lr, cls_ratio):
            n = next(iter(batch.values())).shape[0] // 2
            return step({key: v[:n] for key, v in batch.items()}, lr,
                        cls_ratio)
        return half
    sound, broken = sound_and_broken(
        "train_cycle_b12", monkeypatch,
        lambda m: m.setattr(steps, "make_train_step", halved))
    assert_caught(sound, broken)
    assert np.isfinite(readings(broken)["loss_step1"])
