"""First-use costs of a run, attributed to named phases. The port's
counterpart of `usot_tpu/utils/compile_watch.py`.

JAX's watch counts XLA compiles and persistent-cache hits. The port
compiles no programs; what a phase can pay on first use is

  - the correlation kernels' libraries built with nvcc (and the seconds
    nvcc took) against those found built under `usot_tpu_torch/_build/`
    (hits), and the libraries bound with `ctypes`: the loader
    (`ops/xcorr_kernel.py`) reports each through `BUILD_LISTENERS`;
  - the CUDA context's lazy initialisation, paid by the first call that
    touches the card (`torch.cuda.is_initialized()` before and after).

Used by `tools/bench.py`, which logs one line per phase:

  compile[<phase>]: <wall>s wall | kernels: <h> cached + <m> built
  (<s>s nvcc) | cuda init <yes/no>
"""
from __future__ import annotations

import contextlib
import sys
import time
from collections import Counter, defaultdict

import torch

from usot_tpu_torch.ops import xcorr_kernel

_BUILT, _CACHED, _LOADED = "built", "cached", "loaded"


class CompileWatch:
    """Register once per process (`get_watch`), snapshot per phase."""

    def __init__(self):
        self.counts = Counter()
        self.durations = defaultdict(float)
        xcorr_kernel.BUILD_LISTENERS.append(self._on_event)

    def _on_event(self, event, source, seconds):
        self.counts[event] += 1
        self.durations[event] += seconds

    def snapshot(self) -> dict:
        return {
            "built": self.counts[_BUILT],
            "cached": self.counts[_CACHED],
            "loaded": self.counts[_LOADED],
            "nvcc_s": self.durations[_BUILT],
            "cuda_initialized": torch.cuda.is_initialized(),
        }

    @staticmethod
    def _delta(a: dict, b: dict) -> dict:
        d = {k: b[k] - a[k] for k in a if k != "cuda_initialized"}
        d["cuda_init"] = b["cuda_initialized"] and not a["cuda_initialized"]
        return d

    def format_delta(self, d: dict, wall_s: float) -> str:
        return (f"{wall_s:.1f}s wall | kernels: {d['cached']} cached + "
                f"{d['built']} built ({d['nvcc_s']:.1f}s nvcc) | cuda init "
                f"{'yes' if d['cuda_init'] else 'no'}")

    @contextlib.contextmanager
    def phase(self, name: str, log=None, record: list | None = None):
        """Context manager: logs the first-use costs of a code region via
        `log(msg)` (default: print to stderr); appends {"phase", "wall_s",
        and the delta} to `record` when one is given."""
        before = self.snapshot()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            d = self._delta(before, self.snapshot())
            msg = f"compile[{name}]: {self.format_delta(d, wall)}"
            if record is not None:
                record.append({"phase": name, "wall_s": wall, **d,
                               "line": msg})
            if log is None:
                print(msg, file=sys.stderr, flush=True)
            else:
                log(msg)


_WATCH = None


def get_watch() -> CompileWatch:
    global _WATCH
    if _WATCH is None:
        _WATCH = CompileWatch()
    return _WATCH
