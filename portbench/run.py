"""The benchmark of `usot_tpu_torch` (the PyTorch and CUDA port of USOT*)
on NVIDIA GPUs. From the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (`portbench/configs/`)
and a traffic mix (`portbench/traffic/<traffic>.json`, which names the
driver in `portbench/drivers/` that runs it). The run makes its weights
and inputs on the card from `--seed`, sets up and warms the cell's
shapes, measures for `--seconds` seconds, checks what the timed path
produced against the plain reference (`portbench/reference/`), and
prints one JSON line last on standard output. With `--trace 1` the
window runs under `torch.profiler` and the line carries the cell's
per-layer metrics (`portbench/metrics/<metric>.py`) instead of its
end-to-end ones. It exits non-zero, with no result, where there is no
card, where the cell asks for more cards than there are, or where JAX,
flax or the JAX package were loaded.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started (Linux's /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import main as run

    return run(argv, root=ROOT, started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
