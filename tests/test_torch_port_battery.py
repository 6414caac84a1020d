"""The battery digest (`usot_tpu_torch.tools.process_battery`) of records
the port's tools write on the CPU at the fixture's widths: `bench_memops`,
`microbench_step`, `tools.bench` (its record as `main` writes it),
`accuracy_parity_run`, `cliff_sweep`, `cliff_bisect` and
`bench_lockstep`. The sections come in the JAX tool's order
(`tools/process_battery.py:54-95`) and then the cliff and lockstep ones;
every record that is missing (here: `bench_xcorr`, which needs a card,
and the B=48 / 64 benches) prints "not measured", and a CPU record's
times are "not measured" too, never a number from elsewhere.
"""
import json
import os

import numpy as np
import pytest
import torch

from usot_tpu_torch.tools import (accuracy_parity_run, bench, bench_lockstep,
                                  bench_memops, cliff_bisect, cliff_sweep,
                                  microbench_step, process_battery)

from torch_port_common import CHANNELS, FIXTURE, WIDTH

torch.set_num_threads(2)
MODEL = ["--device", "cpu", "--ckpt", FIXTURE, "--width", str(WIDTH),
         "--channels", str(CHANNELS)]
SECTIONS = ["== 1: memops", "== 2: xcorr kernels", "== 3: step attribution",
            "== 4-8: headline benches", "== 5: accuracy parity",
            "== 6: cliff sweep and bisect", "== 7: lockstep benches"]


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    d = tmp_path_factory.mktemp("battery")
    bench_memops.main(["--device", "cpu", "--batch", "2", "--slots", "9",
                       "--frames", "2", "--channels", "8", "--json",
                       str(d / "memops.json")])
    microbench_step.run(microbench_step.parse_args(
        MODEL + ["--batch", "1", "--iters", "1", "--max-frames", "48",
                 "--json", str(d / "step.json")]))
    from usot_tpu_torch.train.checkpoint import load_model_state

    rec = bench.run(load_model_state(FIXTURE), torch.device("cpu"),
                    frames=9, chunk=4, batch=1, h=320, w=288, roi="0",
                    stream_chunk=4, repeats=1, width=WIDTH,
                    channels=CHANNELS)
    rec.pop("tracks")
    rec["card"] = "cpu"
    with open(d / "bench.json", "w") as f:
        json.dump(rec, f)
    accuracy_parity_run.main([
        "--device", "cpu", "--videos", "1", "--frames", "8", "--width",
        str(WIDTH), "--channels", str(CHANNELS), "--mem_size", "2",
        "--ckpt", FIXTURE, "--root", str(d / "parity_bench"), "--json",
        str(d / "parity.json")])
    cliff_sweep.run(cliff_sweep.parse_args(
        MODEL + ["--batch", "2", "--iters", "1", "--stages", "xcorr_pair",
                 "--json", str(d / "cliff_b2.json")]))
    cliff_bisect.run(cliff_bisect.parse_args(
        MODEL + ["--batch", "2", "--iters", "1", "--chains", "A", "--json",
                 str(d / "bisect_b2.json")]))
    bench_lockstep.run(bench_lockstep.parse_args(
        MODEL + ["--vot", "--batch", "2", "--frames", "18", "--chunk", "8",
                 "--failures", "1", "--reps", "1", "--json",
                 str(d / "lockstep.json")]))
    return d


def _section(text, i):
    lines = text.splitlines()
    start = next(k for k, ln in enumerate(lines)
                 if ln.startswith(SECTIONS[i]))
    end = next((k for k, ln in enumerate(lines)
                if i + 1 < len(SECTIONS) and ln.startswith(SECTIONS[i + 1])),
               len(lines))
    return [ln for ln in lines[start + 1:end] if ln]


def test_sections_come_in_the_jax_tools_order(battery):
    text = process_battery.main(["--dir", str(battery), "--device", "cpu"])
    found = [text.index(s) for s in SECTIONS]
    assert found == sorted(found)


def test_each_record_is_digested(battery):
    text = process_battery.digest(str(battery))
    memops = _section(text, 0)
    assert memops[0].startswith("card: cpu; B=2 S=9 T=2 K=5")
    assert all("not measured ms/frame" in ln for ln in memops[1:5])
    assert memops[5] == "correctness: all formulations agree"
    assert _section(text, 1) == ["not measured"]         # no bench_xcorr
    step = _section(text, 2)
    assert step[0] == "card: cpu; B=1 bf16" and len(step) == 1 + 18 + 1 + 4
    assert "FULL STEP (vmap)" in step[19] and "no counterpart" in step[19]
    heads = _section(text, 3)
    assert heads[0].startswith("B=32 default") and "metric" in heads[0] \
        and heads[0].endswith("[cpu]")
    assert heads[1].endswith(": not measured")       # B=48
    assert heads[2].endswith(": not measured")       # B=64
    parity = _section(text, 4)
    assert [ln.split(":")[0] for ln in parity] == [
        "USOT_parity", "USOT_batch_f32", "USOT_batch_bf16", "USOT_random",
        "delta_USOT_batch_f32", "delta_USOT_batch_bf16"]
    assert heads[3].startswith("ROI leg") and "skipped" in heads[3]
    cliff = _section(text, 5)
    assert cliff[0] == cliff[2] == "card: cpu; bf16"
    assert cliff[1].startswith("B=2 xcorr_pair") and "chain A" in cliff[3]
    lock = _section(text, 6)
    assert lock[0] == "card: cpu" and lock[1].startswith("VOT staged median")


def test_a_missing_record_is_not_measured(battery, tmp_path):
    for name in os.listdir(battery):
        if name != "memops.json" and name.endswith(".json"):
            with open(battery / name) as f, open(tmp_path / name, "w") as g:
                g.write(f.read())
    text = process_battery.digest(str(tmp_path))
    assert _section(text, 0) == ["not measured"]
    assert not any(ch.isdigit() for ch in _section(text, 1)[0])


def test_an_empty_battery_holds_no_number(tmp_path):
    text = process_battery.digest(str(tmp_path))
    body = [ln for ln in text.splitlines()
            if ln and not ln.startswith("==")]
    assert all(ln.endswith("not measured") for ln in body)
    assert np.all([not any(c.isdigit() for c in ln.split(":")[-1])
                   for ln in body])
