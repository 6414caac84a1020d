"""Per-batch sweep of the frame step's stages for a per-step cliff on one
GPU (the counterpart of `tools/cliff_sweep.py`).

    python -m usot_tpu_torch.tools.cliff_sweep --batch 48
        [--stages full,memhead,enc_search,xcorr_pair,groupdw,conf,towers,
         backbone] [--iters 20] [--dtype bf16|f32] [--trace DIR]
        [--device cpu] [--json PATH] [--ckpt PATH] [--width 64]
        [--channels 256]

JAX's full step scaled superlinearly past B=32 on the TPU
(`tools/cliff_sweep.py:3-7`). This tool times the suspect stages at ONE
batch size per call and prints, per stage, device ms per iteration (a
CUDA graph of `--iters` calls, `stage_cost`) beside the eager call, the
GFLOP and MB per iteration (`FlopCounterMode` plus the correlation
kernels' analytic counts; the bound's bytes and the op-level traffic)
and the same per sample: a jump in ms at flat per-sample counts is a
cliff of the card, not of the work.

Stages, on the model `build_usot(mem_size=4, fused_xcorr=True)` (K1 for
every correlation): full (`BatchScanEngine._frame_step_batched`), memhead
(`track_memory_encoded_batched`), enc_search, xcorr_pair (the offline
template correlation, `cls_dw` against one kernel: K1 at M=1), groupdw
(`GroupDW.multi`, K1 at M=7), conf (`ConfFusion`), towers (the offline
cls and bbox towers and the memory tower with their preds), backbone
(`search_features`). Every call ends in full-tensor means
(`stage_cost.readout`), as the JAX tool insists (`:9-16`).

`--hlo DIR` has no PyTorch counterpart; `--trace DIR` writes one
`torch.profiler` Chrome trace per stage (`<stage>_B<batch>/trace.json`,
`utils.profiling.trace` over two graph-free eager calls). Inputs as
`microbench_step`'s (the engine's 31x31 search feature). Runs on the GPU
unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os

import torch

from usot_tpu_torch.tools import microbench_step as mb
from usot_tpu_torch.tools import stage_cost as sc
from usot_tpu_torch.utils import profiling

ALL_STAGES = ("full", "memhead", "enc_search", "xcorr_pair", "groupdw",
              "conf", "towers", "backbone")


def stage_fns(model, engine, t: dict) -> dict:
    """{name: fn of no arguments returning the stage's outputs} on the
    device inputs `t` (`microbench_step.to_device`)."""
    from usot_tpu_torch.models.layers import to_nchw

    head = model.connect_model
    b = t["pos"].shape[0]
    zf_enc = model.encode_template(t["zf"])
    cls_x_real, _ = head.encode_search(t["xf"])
    state = mb.engine_state(model, t)
    origin = torch.zeros((b, 2), device=t["pos"].device)
    valid = torch.ones(b, dtype=torch.bool, device=t["pos"].device)

    def groupdw():
        qe = [q.reshape((b * mb.N_Q,) + tuple(q.shape[2:]))
              for q in t["queue_enc"]]
        return head.cls_dw.multi(qe, cls_x_real, mb.N_Q)

    def towers():
        x = to_nchw(t["fused_map"])
        return (head.cls_pred(head.cls_tower(x))
                + head.bbox_pred(head.bbox_tower(x))[:, :1]
                + head.cls_memory_pred(head.cls_memory_tower(x)))

    return {
        "full": lambda: engine._frame_step_batched(
            state, t["frames"], valid, t["avg"], t["hw"], origin),
        "memhead": lambda: model.track_memory_encoded_batched(
            t["xf"], zf_enc, tuple(t["queue_enc"])),
        "enc_search": lambda: head.encode_search(t["xf"]),
        "xcorr_pair": lambda: head.cls_dw(list(zf_enc[0]), cls_x_real),
        "groupdw": groupdw,
        "conf": lambda: head.conf_fusion(t["dw_maps"]),
        "towers": towers,
        "backbone": lambda: model.search_features(t["x_crop"]),
    }


def line(b: int, r: dict) -> str:
    ms = sc.fmt(r["device_ms"])
    return (f"B={b} {r['stage']:12s} {ms:>12s} ms/iter (eager "
            f"{r['call_ms']:.3f})  {r['gflop']:8.2f} GFLOP/iter  "
            f"{r['min_mb']:8.1f} MB/iter bound, {r['op_mb']:8.1f} op  "
            f"({r['mflop_per_sample']:.1f} MF/sample, "
            f"{r['min_kb_per_sample']:.1f} / {r['op_kb_per_sample']:.1f} "
            "kB/sample)")


def run(args, weights=None) -> dict:
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = set(stages) - set(ALL_STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}")
    device, card = sc.open_device(args)
    b = args.batch
    rec = {"tool": "cliff_sweep", "card": card, "device": str(device),
           "batch": b, "dtype": args.dtype, "iters": args.iters,
           "stages": []}
    with torch.inference_mode():
        model = sc.load_model(args, device, args.dtype, weights)
        p = mb.tracker_config()
        t = mb.to_device(mb.make_inputs(b, 256 if "full" in stages else 8,
                                        args.channels),
                         sc.DTYPES[args.dtype], device)
        engine = BatchScanEngine(model, p, mb.H, mb.W, batch=b,
                                 max_frames=t["mem_conf"].shape[1], chunk=8,
                                 device=device)
        fns = stage_fns(model, engine, t)
        for name in stages:
            r = sc.measure(name, fns[name], device, args.dtype, args.iters,
                           b)
            if args.trace:
                log_dir = os.path.join(args.trace, f"{name}_B{b}")
                with profiling.trace(log_dir):
                    for _ in range(2):
                        sc.readout(fns[name]())
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                r["trace"] = os.path.join(log_dir, "trace.json")
            print(line(b, r), flush=True)
            rec["stages"].append(r)
    sc.write_json(args.json, rec)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--stages", default=",".join(ALL_STAGES))
    ap.add_argument("--dtype", choices=sorted(sc.DTYPES), default="bf16")
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler Chrome trace per stage "
                    "into this directory (in place of JAX's --hlo)")
    return sc.common_args(ap).parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
