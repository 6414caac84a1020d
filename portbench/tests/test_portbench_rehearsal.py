"""Each cell end to end on the CPU at small widths: the driver's control
flow, the window's accounting, the result line and, traced, the
per-layer metrics and the breakdown. The real command still refuses a
machine without a card."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, small_context
from portbench import harness

CELLS = ("track_b64_staged", "train_cycle_b12", "track_b1_live",
         "mine_got10k_720p")
KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(cell):
    bench, ctx = small_context(cell)
    line = harness.run_cell(ctx, bench)
    assert tuple(line)[:5] == KEYS and tuple(line)[-1] == "checks"
    e2e, _ = harness.cell_metrics(bench, cell)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert "setup_s" in line["metrics"]
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    bench, ctx = small_context(cell, trace=True)
    line = harness.run_cell(ctx, bench)
    _, layer = harness.cell_metrics(bench, cell)
    names = {m["name"] for m in layer}
    assert set(line["metrics"]) <= names
    # the CPU trace has no device work: launches read 0 and the idle
    # share 100; what needs device time (K1) reads nothing
    assert any(n.startswith("device_idle_pct") for n in line["metrics"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert "k1_roofline_pct" not in line["metrics"]


def test_staged_window_counts_whole_rounds():
    bench, ctx = small_context("track_b64_staged")
    line = harness.run_cell(ctx, bench)
    per_round = 2 * 8  # lanes * tracked frames of a round
    assert line["attempted"] % per_round == 0


def test_command_refuses_a_machine_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "track_b64_staged",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
