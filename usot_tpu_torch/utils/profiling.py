"""Profiling / tracing helpers (SURVEY §5.1: the reference has only coarse
wall-clock FPS counters; we keep those as the north-star metric and add
trace capture).

The port's own copy of `usot_tpu/utils/profiling.py`: `trace` captures a
`torch.profiler` trace (the CPU, and the card where there is one) and
exports it as a Chrome trace (view it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a `torch.profiler` trace into `log_dir/trace.json` when
    set; no-op otherwise. Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    import torch
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
