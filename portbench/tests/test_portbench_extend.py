"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries in BENCHMARK.json, with no edit to any file that
is there: a dummy cell, from a copy of the benchmark in a temporary
directory."""
import json
import shutil

from conftest import ROOT, small_context
from portbench import harness


def test_a_cell_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/usot_star_r50_bf16.json")
                     .read_text())
    cfg.update(name="dummy_f32", dtype="float32")
    (tmp_path / "portbench/configs/dummy_f32.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/staged_b64_480p.json")
                         .read_text())
    traffic.update(lanes=3)
    (tmp_path / "portbench/traffic/dummy_mix.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/dummy_frames_per_step.py").write_text(
        "def read(ctx, out):\n"
        "    return out.counts['frames'] / out.counts['steps']\n")
    bench["configs"].append({"name": "dummy_f32", "source": "a test",
                             "file": "portbench/configs/dummy_f32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_f32",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dummy_cell")
    bench["per_layer"].append({
        "name": "dummy_frames_per_step", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "track_fps", "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench, ctx = small_context("dummy_cell", root=tmp_path, trace=True,
                               traffic={"lanes": 3, "check_lanes": 1})
    line = harness.run_cell(ctx, bench)
    assert line["metrics"]["dummy_frames_per_step"]["value"] == 3
    assert ctx.config["dtype"] == "float32"
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)
