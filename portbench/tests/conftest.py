"""The benchmark's tests: CPU rehearsals at small widths, and the
controls on the card (marked `gpu`; they skip without one)."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

TINY = {"width": 8, "channels": 32}
SMALL = {
    "track_b64_staged": dict(lanes=2, canvas=[120, 160], frames_per_video=9,
                             chunk=4, max_frames=16, box_px=[30, 40],
                             speed_px=[0.5, 1.0], check_lanes=2,
                             trace_seconds=0.5),
    "train_cycle_b12": dict(batch=2, mem_num=2, distinct_batches=3,
                            trace_seconds=0.5),
    "track_b1_live": dict(frame=[120, 160], lengths=[5, 7, 9],
                          box_px=[40, 60], speed_px=[0.5, 1.0],
                          check_frames=10, trace_seconds=0.5),
}


# A cell whose files are here and whose entries are not (yet) in
# BENCHMARK.json: its runs on the card spread too widely for any bound
# the benchmark may set (PERF.md). Its tests run it with these entries.
PARKED = {
    "workloads": [{"name": "track_b1_live", "config": "usot_star_r50_bf16",
                   "traffic": "live_b1_720p", "chips": 1,
                   "why": "one closed-loop client, 720p uint8 frames"}],
    "end_to_end": [{"name": "frame_ms_p95", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["track_b1_live"]}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower",
                   "source": "device_trace", "layer": layer,
                   "moves": "frame_ms_p95", "workloads": ["track_b1_live"]}
                  for name, unit, layer in (
                      ("launches_per_frame.live", "launches", "tracker loop"),
                      ("device_idle_pct.live", "%", "device"))],
}


def benchmark(root: Path = ROOT) -> dict:
    """BENCHMARK.json at `root` with the parked cell's entries added."""
    bench = harness.load_json(root / "BENCHMARK.json")
    for key, entries in PARKED.items():
        bench[key] = bench[key] + entries
    return bench


def small_context(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
                  trace: bool = False, root: Path = ROOT, config=None,
                  traffic=None, device="cpu"):
    """(BENCHMARK.json with the parked cell, a Context for `cell` at the
    test sizes on `device`), with `config` / `traffic` entries laid over
    the cell's."""
    bench, cell_entry, cfg, tr = harness.find_cell(root, cell,
                                                   benchmark(root))
    cfg.update(TINY)
    cfg.update(config or {})
    tr.update(SMALL.get(cell, {}))
    tr.update(traffic or {})
    ctx = harness.Context(root=root, cell=cell_entry, config=cfg,
                          traffic=tr, seed=seed, seconds=seconds,
                          trace=trace, device=torch.device(device),
                          started=time.time())
    return bench, ctx


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
