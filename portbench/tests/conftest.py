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
    "mine_got10k_720p": dict(frame=[192, 256], lengths=[16, 19],
                             object_frac=[0.2, 0.35], warm_frames=10,
                             trace_seconds=0.5),
}
# configuration entries of a cell at the test sizes (the flow network's
# test shape: its sides multiples of 64, as PWCLite's pyramid needs)
SMALL_CONFIG = {"mine_got10k_720p": dict(test_shape=[128, 192],
                                         flow_gain=14.5,
                                         mining=dict(gap=3, init_adjacent=4,
                                                     cut_ratio=0.03125,
                                                     instance_size=127,
                                                     max_frames=2000,
                                                     quality_gate=False))}


def small_context(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
                  trace: bool = False, root: Path = ROOT, config=None,
                  traffic=None, device="cpu"):
    """(BENCHMARK.json with the parked cells, a Context for `cell` at the
    test sizes on `device`), with `config` / `traffic` entries laid over
    the cell's."""
    bench, cell_entry, cfg, tr = harness.find_cell(root, cell)
    cfg.update(TINY)
    cfg.update(SMALL_CONFIG.get(cell, {}))
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
