"""Spans around the benchmark's calls into the program, and the reduction
of a `torch.profiler` trace of the measured window.

`span(name)` is a `record_function` named `pb.<name>`: the benchmark's
own host-side spans (init, chunk, step, upload, crop, postprocess...),
none inside the program. `Profile` records CPU and CUDA activity over a
block, and `reduce` turns it into the numbers the per-layer readers and
the result's breakdown read:

* device operations: the trace's kernels, copies and fills (GPU user
  annotations, which mirror host spans onto the device's timeline, are
  not device work);
* `busy_s`: the union of their intervals inside the window (the
  `pb.window` span), so overlapping operations count once; `window_s`
  that span's length;
* `kernels`: the number of kernel launches in the window, and
  `kernel_s`, device seconds by kernel name;
* `device_ops`: the 10 names with the most device seconds;
* `idle_gaps`: idle device seconds inside the window summed by the
  innermost `pb.` span the host was in (a gap that spans several is
  split among them), the 10 largest (`host outside any span` where
  there is none).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

PREFIX = "pb."


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


class Profile:
    """`with Profile(on) as p:` ... ; then `p.summary()`. Off, it records
    nothing and `summary()` is None."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self._window = span("window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        self._window.__exit__(*exc)
        if self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict | None:
        if self.prof is None:
            return None
        return reduce(self.prof.profiler.kineto_results.events())


def _kind(event) -> str:
    """'kernel', 'memory' (a copy or fill) or '' for a trace event, by its
    name: a device event named like a host span is a GPU user annotation,
    and copies and fills are named `Memcpy ...` and `Memset ...`."""
    if event.device_type() != torch.autograd.DeviceType.CUDA:
        return ""
    name = event.name()
    if name.startswith(PREFIX) or _annotation(event):
        return ""
    return "memory" if name.startswith(("Memcpy", "Memset")) else "kernel"


def _annotation(event) -> bool:
    return bool(getattr(event, "is_user_annotation", lambda: False)())


def reduce(events) -> dict:
    spans, device = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU \
                and e.name().startswith(PREFIX):
            spans.append((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]))
            continue
        kind = _kind(e)
        if kind:
            device.append((e.start_ns(), e.end_ns(), e.name(), kind))
    window = [s for s in spans if s[2] == "window"]
    if not window:
        raise RuntimeError("the trace has no window span")
    w0, w1 = window[0][0], window[0][1]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    device.sort()
    by_name = defaultdict(float)
    launches = 0
    union, busy = [], 0
    for start, end, name, kind in device:
        by_name[name] += (end - start) * 1e-9
        launches += kind == "kernel"
        start, end = max(start, w0), min(end, w1)
        if union and start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], end)
        else:
            union.append([start, end])
    busy = sum(b - a for a, b in union)
    gaps, prev = [], w0
    for a, b in union:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))
    idle = _attribute(gaps, [s for s in spans if s[2] != "window"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernels": launches, "kernel_s": dict(by_name),
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]]}


def _attribute(gaps, spans) -> dict:
    """Idle seconds by the innermost span the host was in: each gap cut
    where a span starts or ends inside it, and each piece given to the
    innermost span covering its middle (the host's spans nest, so
    walking back from the latest one started, the first that still runs
    is the innermost; 64 looked at, at most)."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    edges = sorted({t for s in spans for t in s[:2]})
    out = defaultdict(float)
    for a, b in gaps:
        cuts = [a, *edges[bisect.bisect_right(edges, a):
                          bisect.bisect_left(edges, b)], b]
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) // 2
            name = "host outside any span"
            first = bisect.bisect_right(starts, mid) - 1
            for i in range(first, max(first - 64, -1), -1):
                if spans[i][1] >= mid:
                    name = spans[i][2]
                    break
            out[name] += (hi - lo) * 1e-9
    return out


def sync(device):
    """Waits for `device`'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory so far (0 on the
    CPU)."""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def release(device):
    """Returns the allocator's cached blocks to the card, so the check
    that follows a window finds the program's memory free."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
