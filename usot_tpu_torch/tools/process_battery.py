"""Digest one measurement battery of the port into one block for
`PERF.md` (the counterpart of `tools/process_battery.py`).

    python -m usot_tpu_torch.tools.process_battery
        [--dir chiprun_out/battery] [--device cpu]

The JAX tool reads the TPU battery's logs (`tools/tpu_worklist.sh`, left
out by decision); this one reads the JSON records the port's tools write
with `--json` into `--dir`:

  memops.json           `bench_memops`
  xcorr.json            `bench_xcorr`
  step.json             `microbench_step`
  bench.json, bench_b48.json, bench_b64.json, bench_roi.json
                        `tools.bench` (BENCH_BATCH 32 / 48 / 64; the ROI
                        leg of bench_roi.json, else of bench.json)
  parity.json           `accuracy_parity_run`
  cliff_b<B>.json, bisect_b<B>.json, lockstep.json
                        `cliff_sweep`, `cliff_bisect`, `bench_lockstep`

Sections in the JAX tool's order (memops, xcorr kernels, step
attribution, headline benches, accuracy parity), then the cliff and the
lockstep benches. A record that is missing prints "not measured", never
a number from elsewhere. The card's line comes first, and each record's
card line is printed with it.
The records are the card's: without a GPU it raises unless `--device
cpu` is given (a CPU rehearsal's records, which hold no device time).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

from usot_tpu_torch.tools.stage_cost import fmt

NOT_MEASURED = "not measured"


def read(d, name):
    path = os.path.join(d, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def memops(rec) -> list:
    if rec is None:
        return [NOT_MEASURED]
    out = [f"card: {rec['card']}; B={rec['batch']} S={rec['slots']} "
           f"T={rec['frames']} K={rec['k']} ring MB={rec['ring_mb']:.1f}"]
    for r in rec["rows"]:
        out.append(f"  gather={r['gather']:6s} write={r['write']:7s}: "
                   f"{fmt(r['ms_per_frame'])} ms/frame (bound "
                   f"{r['bound_ms'] * 1e3:.2f} us)")
    out.append("correctness: " + ("all formulations agree"
                                  if rec.get("correct") else "FAILED"))
    return out


def xcorr(rec) -> list:
    if rec is None:
        return [NOT_MEASURED]
    return [f"card: {rec['card']}; B={rec['batch']} {rec['dtype']}"] + [
        f"{r['stage']:72s} {fmt(r['ms'])} ms/call" for r in rec["records"]]


def step(rec) -> list:
    if rec is None:
        return [NOT_MEASURED]
    out = [f"card: {rec['card']}; B={rec['batch']} {rec['dtype']}"]
    for r in rec["stages"]:
        share = r.get("share_pct")
        out.append(f"{r['stage']:34s} {fmt(r['device_ms']):>12s} device ms "
                   f" {fmt(r['call_ms']):>10s} eager ms  bound "
                   f"{r['bound_ms']:.4f} ({r['bound']}), share "
                   f"{fmt(share, '.1f')}")
    out.append(f"{'FULL STEP (vmap)':34s} {rec['vmap']}")
    for r in rec.get("chunk", []):
        out.append(f"{r['stage']:34s} {fmt(r['ms_per_frame']):>12s} "
                   "ms/frame (events)")
    return out


def bench(rec) -> str:
    if rec is None:
        return NOT_MEASURED
    line, legs = rec["line"], rec["legs"]
    return (f"metric {line['value']} {line['unit']} (vs_baseline "
            f"{line['vs_baseline']}x); staged median "
            f"{legs['staged']['median_fps']:.1f} fps; streaming "
            f"{legs['fullframe_stream']['fps']:.1f} fps [{rec['card']}]")


def roi(rec) -> str:
    if rec is None:
        return NOT_MEASURED
    leg = rec["legs"]["roi"]
    if "fps" not in leg:
        return f"ROI-{leg['roi']} skipped (the window does not fit)"
    return (f"ROI-{leg['roi']} streaming {leg['fps']:.1f} fps "
            f"({leg['roi_replays']}/{leg['roi_chunks']} chunks replayed) "
            f"[{rec['card']}]")


def parity(rec) -> list:
    if rec is None:
        return [NOT_MEASURED]
    return [f"{tag}: AUC {r['auc']:.4f}  precision@20 {r['precision20']:.4f}"
            if not tag.startswith("delta") else
            f"{tag}: AUC {r['auc']:.4f}  precision {r['precision20']:.4f}"
            for tag, r in rec.items() if isinstance(r, dict)]


def cliff(d) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(d, "cliff_b*.json")),
                       key=lambda p: int(re.findall(r"\d+", p)[-1])):
        with open(path) as f:
            rec = json.load(f)
        out.append(f"card: {rec['card']}; {rec['dtype']}")
        for r in rec["stages"]:
            out.append(f"B={rec['batch']} {r['stage']:12s} "
                       f"{fmt(r['device_ms']):>12s} ms/iter  "
                       f"{r['mflop_per_sample']:.1f} MF/sample  "
                       f"{r['min_kb_per_sample']:.1f} kB/sample")
    for path in sorted(glob.glob(os.path.join(d, "bisect_b*.json")),
                       key=lambda p: int(re.findall(r"\d+", p)[-1])):
        with open(path) as f:
            rec = json.load(f)
        out.append(f"card: {rec['card']}; {rec['dtype']}")
        for r in rec["chains"]:
            out.append(f"B={rec['batch']} {r['stage']}   "
                       f"{fmt(r['device_ms']):>12s} ms/iter  "
                       f"{r['gflop']:.2f} GFLOP/iter")
    return out or [NOT_MEASURED]


def lockstep(rec) -> list:
    if rec is None:
        return [NOT_MEASURED]
    out = [f"card: {rec['card']}"]
    if "vot" in rec:
        v = rec["vot"]
        out.append(f"VOT staged median {v['median_fps']:.1f} fps (B="
                   f"{rec['args']['batch']}, {v['reps'][-1]['restarts']} "
                   "restarts)")
    if "refill" in rec:
        r = rec["refill"]
        out.append(f"refill {r['refill_fps']:.1f} fps, padded "
                   f"{r['padded_fps']:.1f} fps, speedup {r['speedup']:.2f}x "
                   f"({r['refills']} refills)")
    return out or [NOT_MEASURED]


def digest(d: str) -> str:
    """The battery under `d` as one text block."""
    lines = ["== 1: memops (ring gather/write formulations) =="]
    lines += memops(read(d, "memops.json"))
    lines += ["", "== 2: xcorr kernels (device ms/call) =="]
    lines += xcorr(read(d, "xcorr.json"))
    lines += ["", "== 3: step attribution =="]
    lines += step(read(d, "step.json"))
    lines += ["", "== 4-8: headline benches =="]
    for stem, tag in (("bench", "B=32 default"), ("bench_b48", "B=48"),
                      ("bench_b64", "B=64")):
        lines.append(f"{tag:26s}: {bench(read(d, stem + '.json'))}")
    lines.append(f"{'ROI leg':26s}: "
                 f"{roi(read(d, 'bench_roi.json') or read(d, 'bench.json'))}")
    lines += ["", "== 5: accuracy parity (engine vs parity tracker) =="]
    lines += parity(read(d, "parity.json"))
    lines += ["", "== 6: cliff sweep and bisect =="]
    lines += cliff(d)
    lines += ["", "== 7: lockstep benches =="]
    lines += lockstep(read(d, "lockstep.json"))
    return "\n".join(lines)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="chiprun_out/battery")
    ap.add_argument("--device", default=None,
                    help="the battery's device (default: the GPU; raises "
                    "without one). `cpu` digests a CPU rehearsal's records")
    args = ap.parse_args(argv)
    from usot_tpu_torch.core.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        from usot_tpu_torch.tools.timing import card_line

        print(card_line(), flush=True)
    text = digest(args.dir)
    print(text, flush=True)
    return text


if __name__ == "__main__":
    main()
