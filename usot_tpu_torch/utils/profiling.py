"""Profiling / tracing helpers (SURVEY §5.1: the reference has only coarse
wall-clock FPS counters; we keep those as the north-star metric and add
trace capture).

The port's own copy of `usot_tpu/utils/profiling.py`: `trace` captures a
`torch.profiler` trace (the CPU, and the card where there is one) and
exports it as a Chrome trace (view it in Perfetto or chrome://tracing).

`span(name, id)` marks a layer boundary inside the program (the engine's
init, frame step and its stages, read-back; the training step and its
phases). It records only while a torch profiler records (the benchmark's
traced window, `trace`, `tools.profile_engine`); otherwise it returns one
shared no-op context. While on, each span is a `record_function` named
`usot.<name>` in the exported trace, beside the kernels it launched, and
an entry of an in-memory record (`spans()`) stamped with `time.time_ns()`,
the epoch clock kineto stamps its CPU events with. The record holds one
profiled session, at most `LIMIT` entries, and nothing is written to
disk: the first span recorded after one was asked for with no profiler
on, or after the record was read, starts it afresh. Spans are entered
from one thread (the engine's and the trainer's); they nest, so a child
lies inside its parent and siblings do not overlap.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "usot."
LIMIT = 1 << 18   # entries of one session; later spans are not recorded


class Span(NamedTuple):
    """One recorded span. `parent`: the index in the record of the span
    it was entered in (None at the top); `id` its caller's identifier
    (a round, a step), inherited from the parent when not given."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    id: object


_OFF = contextlib.nullcontext()
_record: list = []
_open: list = []          # indices of the recorded spans not yet left
_session = 0
_stale = False            # the next recorded span starts a new session


class _On:
    __slots__ = ("name", "id", "fn", "index", "session")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        parent = _open[-1] if _open else None
        if self.id is None and parent is not None:
            self.id = _record[parent].id
        self.fn = torch.profiler.record_function(
            PREFIX + self.name, None if self.id is None else str(self.id))
        # the profiler stamps its event inside `__enter__` and at the end
        # of `__exit__`: take the middle of the one, the end of the other
        before = time.time_ns()
        self.fn.__enter__()
        start = (before + time.time_ns()) // 2
        self.session, self.index = _session, None
        if len(_record) < LIMIT:
            self.index = len(_record)
            _record.append(Span(self.name, start, None, parent, self.id))
            _open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        end = time.time_ns()
        if self.index is not None and self.session == _session:
            _record[self.index] = _record[self.index]._replace(end_ns=end)
            _open.pop()
        return False


def span(name: str, id=None):
    """A context around one layer's work: the shared no-op context while
    no torch profiler records, else a recorded `usot.<name>` span (the
    first of a new profiled session clears the record)."""
    global _stale, _session
    if not _autograd_profiler._is_profiler_enabled:
        _stale = True
        return _OFF
    if _stale:
        _stale = False
        _session += 1
        _record.clear()
        _open.clear()
    return _On(name, id)


def spans() -> list:
    """The record of the newest profiled session: a list of `Span`, in the
    order they were entered."""
    global _stale
    _stale = True
    return list(_record)


def self_ns(record: list) -> list:
    """Each span's self time, ns: its duration less the part of it its
    children cover (children nest inside their parent, one after
    another). `record` as `spans()` returns it, every span closed."""
    out = [s.end_ns - s.start_ns for s in record]
    for s in record:
        if s.parent is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a `torch.profiler` trace into `log_dir/trace.json` when
    set; no-op otherwise. Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FPSMeter:
    """Per-video FPS counter matching the reference's printout
    (ref: scripts/test_usot.py:130-131)."""

    def __init__(self):
        self.total = 0.0
        self.frames = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, n_frames: int = 1):
        self.total += time.perf_counter() - self._t0
        self.frames += n_frames

    @property
    def fps(self) -> float:
        return self.frames / max(self.total, 1e-9)
