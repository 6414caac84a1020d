"""Device and call timing on one GPU, shared by `chip_smoke.py` and the
port's benchmark tools. Both need a CUDA device."""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_device_ms(fn, inner: int = 10, reps: int = 50) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph,
    the graph replayed `reps` times between CUDA events; the median
    replay divided by `inner`. Host launch cost is left out. `fn` is
    called 3 + inner times from Python (warm-up and capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)


def time_call_ms(fn, reps: int = 50) -> float:
    """Wall time of one eager call, host launch cost included (median of
    `reps`, each ended by a synchronize)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
