"""The port's own spans (`usot_tpu_torch.utils.profiling.span`) on the CPU
at the committed fixture's widths: off, a span is one shared no-op and
the engine records nothing; under a torch profiler the engine and the
training step record their layer boundaries, nested as the code nests
them, each on the trace's clock, and change no output. Also the pieces
of `tools.profile_engine` that read a trace (busy time as a union of
intervals, idle time by innermost span) or time the spans with no
profiler (`host_clock`)."""
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from usot_tpu_torch.tools import profile_engine
from usot_tpu_torch.utils import profiling

from torch_port_common import (CLS_RATIO, LAMBDA_1, LAYERS_LR, LR, MOMENTUM,
                               WEIGHT_DECAY, train_batch)

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_usot_w8c32.msgpack")
STAGES = ["engine.search", "engine.heads", "engine.post", "engine.memory"]
CLOCK_NS = 50_000   # a span and its kineto event lie this close


def _model(fused_xcorr=True):
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.train.checkpoint import load_model_state
    from usot_tpu_torch.utils.msgpack import read_msgpack

    meta = read_msgpack(FIXTURE)
    model = build_usot(mem_size=int(meta["mem_size"]),
                       width=int(meta["width"]),
                       channels=int(meta["channels"]),
                       fused_xcorr=fused_xcorr)
    model.load_state_dict(load_model_state(FIXTURE))
    return model


@pytest.fixture(scope="module")
def engine_round():
    return _engine_round()


def _engine_round():
    """`one_round()`: one init and two chunks of 2 frames at B=2 on a fresh
    state of one `BatchScanEngine`, returning (pos, sz, score)."""
    from usot_tpu_torch.tracker.config import TrackerConfig
    from usot_tpu_torch.tracker.engine import BatchScanEngine, synthetic_video
    from usot_tpu_torch.tracker.runner import ModelRunner

    model = _model()
    p = TrackerConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    frames = synthetic_video(5, h=320, w=320)
    engine = BatchScanEngine(model, p, 320, 320, batch=2, max_frames=8,
                             chunk=2, device="cpu")
    runner = ModelRunner(model, device="cpu")
    videos = [(frames[0], np.array([200.0, 240.0]), np.array([60.0, 60.0])),
              (frames[0], np.array([190.0, 230.0]), np.array([50.0, 70.0]))]
    lanes = np.stack([np.stack(frames[1:])] * 2)

    def one_round():
        state = engine.init_batch(videos, runner)
        return engine.track_batch(state, lanes, np.array([4, 4]))[1:]
    return one_round


def _profiled(fn):
    """`fn()` under a CPU profiler, inside a span of the caller's own as
    the benchmark's window is (a session's first event pays the
    profiler's set-up after its stamp): (its output, the span record, the
    trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.window"):
            out = fn()
    return out, profiling.spans(), prof.profiler.kineto_results.events()


def _children(rec, i):
    return [s.name for s in rec if s.parent == i]


def _off_the_trace_clock(rec, events) -> list:
    """The recorded spans, each with its `usot.` event (matched by name in
    order), whose start or end lies more than CLOCK_NS from the span's;
    every span must have its event."""
    kineto = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.device_type() == torch.autograd.DeviceType.CPU \
                and e.name().startswith(profiling.PREFIX):
            kineto.setdefault(e.name()[len(profiling.PREFIX):], []).append(e)
    assert sorted(kineto) == sorted({s.name for s in rec})
    off = []
    for name, evs in kineto.items():
        mine = [s for s in rec if s.name == name]
        assert len(evs) == len(mine), name
        off += [(s, e.start_ns(), e.end_ns()) for s, e in zip(mine, evs)
                if abs(e.start_ns() - s.start_ns) > CLOCK_NS
                or abs(e.end_ns() - s.end_ns) > CLOCK_NS]
    return off


def _on_the_trace_clock(fn, tries=3):
    """`_profiled(fn)` whose every span lies within CLOCK_NS of its
    kineto event. The profiler's stamp and the span's are two reads of
    one clock a few us apart; a run in which the scheduler took the CPU
    between two of them (a time slice, ms) is run again, `tries` runs at
    most."""
    for _ in range(tries):
        out, rec, events = _profiled(fn)
        off = _off_the_trace_clock(rec, events)
        if not off:
            return out, rec
    raise AssertionError(f"off the trace's clock in {tries} runs: {off}")


def test_off_records_nothing_and_enters_no_record_function(engine_round,
                                                           monkeypatch):
    assert profiling.span("engine.step", 1) is profiling.span("a")

    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(profiling, "_record", [])
    out = engine_round()
    assert profiling.spans() == []
    assert all(np.isfinite(o).all() for o in out)


def test_engine_round_spans(engine_round):
    """One round of B=2, chunk 2, two chunks: one `engine.init_batch`
    holding one `engine.init_host`, four `engine.step`s each holding the
    four stages in order, one `engine.collate`; the round's ordinal on
    each; every span on the trace's clock; outputs bitwise those of an
    unprofiled round."""
    plain = engine_round()
    _profiled(engine_round)   # the process's first `record_function` is slow
    out, rec = _on_the_trace_clock(engine_round)
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a, b)
    tops = [(i, s) for i, s in enumerate(rec) if s.parent is None]
    assert [s.name for _, s in tops] == (
        ["engine.init_batch"] + ["engine.step"] * 4 + ["engine.collate"])
    (init, _), steps = tops[0], tops[1:5]
    assert _children(rec, init) == ["engine.init_host"]
    for i, _ in steps:
        assert _children(rec, i) == STAGES
    assert len({s.id for s in rec}) == 1 and rec[0].id >= 1
    for s in rec:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = rec[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def test_a_new_session_replaces_the_record(engine_round):
    first = _profiled(engine_round)[1]
    engine_round()
    second = _profiled(engine_round)[1]
    assert len(second) == len(first)
    assert second[0].id == first[0].id + 2
    assert second[0].start_ns > first[-1].end_ns


def test_train_step_spans():
    """One training step at the fixture's widths: `train.step` holds
    forward, backward, gate and update, in order, under its ordinal."""
    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    model = _model(fused_xcorr=False)   # K1 has no backward
    opt, _ = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR, False)
    step = make_train_step(model, opt, False, False, LAMBDA_1)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(1, 2).items()}
    step(batch, LR, CLS_RATIO)
    out, rec = _on_the_trace_clock(lambda: step(batch, LR, CLS_RATIO))
    assert np.isfinite(float(out["loss"])) and step.skipped == 0
    assert [s.name for s in rec if s.parent is None] == ["train.step"]
    assert _children(rec, 0) == ["train.forward", "train.backward",
                                 "train.gate", "train.update"]
    assert len({s.id for s in rec}) == 1 and rec[0].id >= 2


def test_host_clock_times_the_step_spans_with_no_profiler():
    """`profile_engine.host_clock` times the training step's spans at the
    same boundaries with no profiler: each phase once a step inside its
    `train.step`, the span record left as it was, and `span` restored."""
    from usot_tpu_torch.train import step as step_module
    from usot_tpu_torch.train.optim import build_optimizer

    model = _model(fused_xcorr=False)
    opt, _ = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR, False)
    step = step_module.make_train_step(model, opt, False, False, LAMBDA_1)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(1, 2).items()}
    before = profiling.spans()
    with profile_engine.host_clock(step_module) as took:
        for _ in range(2):
            step(batch, LR, CLS_RATIO)
    assert step_module.span is profiling.span
    assert sorted(took) == sorted(["train.step", "train.forward",
                                   "train.backward", "train.gate",
                                   "train.update"])
    assert all(len(v) == 2 for v in took.values())
    for i in range(2):
        assert took["train.step"][i] >= sum(
            took[k][i] for k in took if k != "train.step")
    assert profiling.spans() == before


def test_self_time_subtracts_the_children():
    S = profiling.Span
    rec = [S("a", 0, 100, None, 1), S("b", 10, 30, 0, 1),
           S("c", 40, 90, 0, 1), S("d", 50, 60, 2, 1)]
    assert profiling.self_ns(rec) == [30, 20, 40, 10]


def test_profile_engine_busy_is_a_union_and_idle_goes_to_the_innermost():
    """Overlapping device work counts once, clipped to the window; each
    idle gap goes to the innermost span running at its middle, or to
    none."""
    ops = [(10, 30, "k"), (20, 40, "k"), (50, 60, "m"), (95, 130, "k")]
    union = profile_engine.busy_intervals(ops, 0, 100)
    assert union == [[10, 40], [50, 60], [95, 100]]
    S = profiling.Span
    rec = [S("engine.step", 2, 70, None, 1), S("engine.search", 12, 38, 0, 1),
           S("engine.heads", 41, 49, 0, 1)]
    idle = profile_engine.idle_by_span(union, 0, 100, rec)
    assert dict(idle) == {"engine.step": 10, "engine.heads": 10,
                          profile_engine.OUTSIDE: 35}
