"""The data-driven core of the benchmark: finds a cell's files by the
names in `BENCHMARK.json`, checks the machine, runs the cell's driver,
reads the per-layer metrics, and prints the result.

A cell (`workloads[]`) names a configuration (`configs[].file`, a JSON
file) and a traffic mix, `portbench/traffic/<traffic>.json`, whose
`"driver"` names a module of `portbench/drivers/`. A driver's
`run(ctx)` sets up, measures, checks and returns an `Outcome`. A
per-layer metric is `portbench/metrics/<metric>.py`, whose
`read(ctx, outcome)` returns a number or None (nothing to read: the
metric is left out of the line). So a cell, a configuration, a traffic
mix or a metric is added as new files and new entries, with no edit to
the files that are here.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "usot_tpu")


@dataclass
class Outcome:
    """What a driver hands back. `e2e`: end-to-end metrics by name (the
    driver fills those its cells report; `setup_s` always). `checks`:
    {name: (number, limit)}, each number held to `number <= limit`.
    `trace`: `portbench.trace.reduce`'s summary of the traced window, or
    None. `counts`: the driver's own work counts over that window, for
    the per-layer readers."""
    e2e: dict
    attempted: int
    failed: int
    checks: dict
    memory_peak_bytes: int
    trace: dict | None = None
    counts: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


@dataclass
class Context:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float
    chips: int = 1

    def window_limit(self) -> float:
        """Seconds the window runs: the run's, or under the profiler at
        most the traffic's `trace_seconds`."""
        return min(self.seconds, self.traffic["trace_seconds"]) \
            if self.trace else self.seconds

    def log(self, msg: str):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def with_parked(root: Path, bench: dict) -> dict:
    """`bench` with the parked cells' entries added: cells whose files are
    here and whose entries are not in BENCHMARK.json, because their runs
    on the card spread too widely for any bound the benchmark may set
    (`portbench/parked.json`; PERF.md). They run as any cell does."""
    parked = load_json(root / "portbench" / "parked.json")
    return {k: v + parked[k] if k in parked else v for k, v in bench.items()}


def find_cell(root: Path, name: str, bench: dict | None = None
              ) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json with the parked cells (or `bench`), the cell, its
    configuration, its traffic mix)."""
    if bench is None:
        bench = with_parked(root, load_json(root / "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in "
                         f"BENCHMARK.json or the parked cells "
                         f"({sorted(cells)})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (bench, cell, load_json(root / config["file"]),
            load_json(root / "portbench" / "traffic"
                      / f"{cell['traffic']}.json"))


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries a cell reports: those
    whose `workloads` list it, or with no such key, every cell (per-layer:
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def load_metric(root: Path, name: str):
    """The reader module of per-layer metric `name` (its file's name is
    the metric's, dots and all)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: `usot_tpu_torch` is not `usot_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(ctx: Context, bench: dict) -> dict:
    """Runs the cell's driver and returns the result's line (a dict)."""
    driver = importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")
    out: Outcome = driver.run(ctx)
    e2e, layer = cell_metrics(bench, ctx.cell["name"])
    metrics = {}
    if ctx.trace:
        for m in layer:
            value = load_metric(ctx.root, m["name"]).read(ctx, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] not in out.e2e:
                raise RuntimeError(f"driver gave no {m['name']}")
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    device = _device(ctx, out)
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.trace:
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    for note in out.notes:
        ctx.log(note)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} = {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    return line


def _device(ctx: Context, out: Outcome) -> dict:
    import torch

    if ctx.device.type == "cuda":
        kind, platform = torch.cuda.get_device_name(0), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    device = {"platform": platform, "kind": kind, "count": ctx.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if ctx.trace and out.trace:
        device.update(busy_s=out.trace["busy_s"],
                      window_s=out.trace["window_s"])
    return device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = None, started: float = None) -> int:
    args = parse_args(argv)
    bench, cell, config, traffic = find_cell(root, args.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = Context(root=root, cell=cell, config=config, traffic=traffic,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0),
                  started=started if started is not None else time.time(),
                  chips=chips)
    line = run_cell(ctx, bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0
