"""Per-stage attribution of the batched frame step on one GPU (the
counterpart of `tools/microbench_step.py`).

    python -m usot_tpu_torch.tools.microbench_step [--batch 32]
        [--iters 20] [--max-frames 256] [--dtype bf16|f32] [--mfu]
        [--only-prefix] [--device cpu] [--json PATH] [--ckpt PATH]
        [--width 64] [--channels 256]

Each stage of `BatchScanEngine`'s step runs on the port's counterpart
of what the JAX tool runs, at B lanes on seeded inputs: the crop
(`core/crop.subwindow_gather` on uint8 frames), `USOTNet.search_features`,
the heads (`track_offline`, `track_memory_batched`,
`track_memory_encoded_batched` and `_fused` on `fold_inference_head`'s
weights), their parts (`encode_search`, `GroupDW.multi` (K1, M=7),
`ConfFusion`, the memory and offline towers), queue assembly
(`_queue_picks` + `_gather_slots`), the memory write and its two ring
formulations (`bench_memops`), `pool_memory_feature`, the pairwise
correlation of a 7x7 kernel (`ops/xcorr.xcorr_depthwise_pairwise`, K3 on
the card) and the FULL STEP (`BatchScanEngine._frame_step_batched`).
Every call ends in `stage_cost.readout` (full-tensor means).

Time: `timing.time_device_ms` (a CUDA graph of `--iters` calls, replayed
between CUDA events: the device cost free of host launches, as JAX's
`jit(lax.scan(...))`) beside `time_call_ms` (the eager call); then the
engine's chunk over T=8 frames without and with `_freeze_invalid`, and
`run_chunk` with and without donation, eager between CUDA events (the
chunk loop holds host work). `--mfu` adds the per-stage roofline table
against this card's peaks (`stage_cost`: FLOPs from `FlopCounterMode`
plus the kernels' analytic counts, the bound's bytes and the op-level
traffic) and writes it with the card's name and power limit to
`var/mfu_inference.json`; `--only-prefix` times only the backbone
prefixes (stem+pool, +layer1, +layer2, +layer3) and their increments.
f32 runs with TF32 off (`core.device.f32_numerics`).

Deviations from the JAX tool: the model is `build_usot(mem_size=4,
fused_xcorr=True)`, the card's production path (`tools.bench`), so the
heads' correlations run K1; the search feature is the engine's
(B, 31, 31, C) (the JAX tool feeds a 29x29 map, two cells under its own
engine's); the "FULL STEP (vmap)" row has no counterpart, the port
writing the batch dimension out, and is printed as such; `--s2d` and
`--s2b` name TPU layout rewrites the port leaves out and raise.
Weights: `stage_cost.load_model` (`tools.bench.load_weights`). Runs on
the GPU unless `--device cpu` is given; on the CPU no device time is
measured.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from usot_tpu_torch.tools import stage_cost as sc
from usot_tpu_torch.tools.bench_memops import SCALES as ENC_HW

H, W = 480, 640           # the benchmark canvas
N_Q = 7                   # memory queue
MEM_LEN = 40              # the rings' logical length in every stage
CHUNK_T = 8               # frames of the chunk rows
VMAP_NOTE = ("no counterpart: the port writes the batch dimension out "
             "(`_frame_step_batched`); JAX's `vmap(_frame_step)` row has "
             "no port to time")
PREFIXES = ((0, "stem+pool"), (1, "+layer1"), (2, "+layer2"),
            (3, "+layer3"))


def tracker_config():
    from usot_tpu_torch.tracker.config import TrackerConfig

    p = TrackerConfig()
    p.instance_size = p.small_sz
    p.renew()
    p.sf_size = p.score_size
    return p


def make_inputs(batch: int, max_frames: int, channels: int = 256,
                seed: int = 0, crop: int = 255, score: int = 25) -> dict:
    """Seeded numpy inputs of the stages: float32 (cast to the compute
    dtype on the device), uint8 frames, int32 ring indices."""
    rng = np.random.default_rng(seed)
    b, c, m = batch, channels, max_frames

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    xf = score + 6            # the search feature of a `crop` px crop
    return {
        "frames": rng.integers(0, 255, (b, H, W, 3), dtype=np.uint8),
        "avg": rng.uniform(90, 140, (b, 3)).astype(np.float32),
        "hw": np.tile(np.float32([H, W]), (b, 1)),
        "pos": rng.uniform(100, 300, (b, 2)).astype(np.float32),
        "x_crop": normal(b, crop, crop, 3),
        "xf": normal(b, xf, xf, c),
        "zf": normal(b, 7, 7, c),
        "queue": normal(b, N_Q, 7, 7, c),
        "mem_feat": normal(b, m, 7, 7, c),
        "mem_conf": rng.uniform(0, 1, (b, m)).astype(np.float32),
        "mem_idx": np.tile(np.arange(m, dtype=np.int32), (b, 1)),
        "mem_len": np.full((b,), MEM_LEN, np.int32),
        "init_feats": normal(b, 2, 7, 7, c),
        "feat": normal(b, 7, 7, c),
        "score_b": rng.uniform(0, 1, (b,)).astype(np.float32),
        # m + 1 slots: the scratch slot of invalid-frame writes
        "mem_enc": [normal(b, m + 1, h, w, c) for h, w in ENC_HW],
        "init_enc": [normal(b, 2, h, w, c) for h, w in ENC_HW],
        "queue_enc": [normal(b, N_Q, h, w, c) for h, w in ENC_HW],
        "dw_maps": normal(b, N_Q, score, score, c),
        "fused_map": normal(b, score, score, c),
    }


def to_device(inputs: dict, dtype, device) -> dict:
    """The inputs on `device`: float32 maps in the compute `dtype`, the
    geometry and the ring bookkeeping in float32 / int32."""
    keep_f32 = {"avg", "hw", "pos", "mem_conf", "score_b"}

    def put(k, a):
        t = torch.from_numpy(a).to(device)
        if t.is_floating_point() and k not in keep_f32:
            t = t.to(dtype)
        return t

    return {k: [put(k, a) for a in v] if isinstance(v, list) else put(k, v)
            for k, v in inputs.items()}


def engine_state(model, t: dict):
    """The engine's carry on the inputs: the template encoded by the
    model, the init anchors and the rings random, `MEM_LEN` frames."""
    from usot_tpu_torch.tracker.engine import EngineState

    b = t["pos"].shape[0]
    zf_enc = model.encode_template(t["zf"])
    return EngineState(
        pos=t["pos"], sz=torch.full((b, 2), 60.0, device=t["pos"].device),
        zf_enc=tuple(tuple(z[:, None] for z in side) for side in zf_enc),
        init_enc=tuple(t["init_enc"]), mem_enc=tuple(t["mem_enc"]),
        mem_conf=t["mem_conf"], mem_idx=t["mem_idx"], mem_len=t["mem_len"])


def stages(model, engine, t: dict, p) -> list:
    """[(name, fn of no arguments returning the stage's outputs)] in the
    JAX tool's order, on the device inputs `t` (`to_device`)."""
    from usot_tpu_torch.core.crop import subwindow_gather
    from usot_tpu_torch.models.layers import to_nchw
    from usot_tpu_torch.ops.xcorr import xcorr_depthwise_pairwise
    from usot_tpu_torch.tools.bench_memops import write_shared
    from usot_tpu_torch.tracker.engine import (_gather_slots,
                                               _memory_write_multi_batched,
                                               _queue_picks, _write_slot,
                                               folded_head)

    head = model.connect_model
    b = t["pos"].shape[0]
    dev = t["pos"].device
    s = p.instance_size
    zf_enc = model.encode_template(t["zf"])
    cls_x_real, _ = head.encode_search(t["xf"])
    fused = folded_head(model)
    state = engine_state(model, t)
    origin = torch.zeros((b, 2), device=dev)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    full_sz = torch.full((b,), 255.0, device=dev)
    feat_enc = tuple(f[:, None] for f in model.encode_memory_kernels(t["feat"]))
    box = torch.tensor([[2.0, 2.0, 20.0, 20.0]], device=dev).repeat(b, 1)

    def crop():
        return subwindow_gather(t["frames"], t["pos"][:, 0], t["pos"][:, 1],
                                full_sz, t["avg"], s, valid_h=t["hw"][:, 0],
                                valid_w=t["hw"][:, 1])

    def queue():
        picks = _queue_picks(t["mem_conf"], t["mem_idx"], t["mem_len"], N_Q)
        return torch.cat([t["init_feats"],
                          _gather_slots(t["mem_feat"], picks)], dim=1)

    def memwrite():
        return _memory_write_multi_batched(
            (t["mem_feat"],), t["mem_conf"], t["mem_idx"], t["mem_len"],
            (t["feat"][:, None],), t["score_b"])

    def memwrite_scatter():
        return _memory_write_multi_batched(
            t["mem_enc"], t["mem_conf"], t["mem_idx"], t["mem_len"],
            feat_enc, t["score_b"], valid)

    def memwrite_shared():
        slot = _write_slot(t["mem_conf"], t["mem_idx"], t["mem_len"],
                           t["mem_conf"].shape[1])
        rings = write_shared(t["mem_enc"], feat_enc, slot, valid)
        lanes = slot[:, None]
        return (rings, t["mem_conf"].scatter(1, lanes, t["score_b"][:, None]),
                t["mem_idx"].scatter(1, lanes, t["mem_len"][:, None]),
                t["mem_len"] + 1)

    def groupdw_multi():
        qe = [q.reshape((b * N_Q,) + tuple(q.shape[2:]))
              for q in t["queue_enc"]]
        return head.cls_dw.multi(qe, cls_x_real, N_Q)

    def offline_towers():
        x = to_nchw(t["fused_map"])
        return head.cls_pred(head.cls_tower(x)) \
            + head.bbox_pred(head.bbox_tower(x))[:, :1]

    def full_step():
        return engine._frame_step_batched(state, t["frames"], valid,
                                          t["avg"], t["hw"], origin)

    return [
        ("crop (u8 frames->255)", crop),
        ("backbone+neck", lambda: model.search_features(t["x_crop"])),
        ("offline head", lambda: model.track_offline(t["xf"], t["zf"])),
        ("offline+memory head", lambda: model.track_memory_batched(
            t["xf"], t["zf"], t["queue"])),
        ("ENC offline+memory head",
         lambda: model.track_memory_encoded_batched(
             t["xf"], zf_enc, tuple(t["queue_enc"]))),
        ("ENC+FOLDED head", lambda: model.track_memory_encoded_fused(
            t["xf"], zf_enc, tuple(t["queue_enc"]), fused)),
        ("  encode_search (6 convs)", lambda: head.encode_search(t["xf"])),
        ("  groupdw multi (fused)", groupdw_multi),
        ("  conf_fusion (B*M maps)", lambda: head.conf_fusion(t["dw_maps"])),
        ("  memory tower+pred", lambda: head.cls_memory_pred(
            head.cls_memory_tower(to_nchw(t["fused_map"])))),
        ("  offline towers+preds", offline_towers),
        ("queue assembly", queue),
        ("memory write", memwrite),
        ("memory write ENC (scatter)", memwrite_scatter),
        ("memory write ENC (shared)", memwrite_shared),
        ("prpool feature", lambda: model.pool_memory_feature(t["xf"], box)),
        ("xcorr shift (1 pair 7x7)",
         lambda: xcorr_depthwise_pairwise(t["xf"], t["zf"])),
        ("FULL STEP (native batched)", full_step),
    ]


def prefix_stages(model, t: dict) -> list:
    """The backbone's prefixes on the crop input (`ResNetPlus2`'s
    `n_stages`), cumulative."""
    backbone = model.features.features
    return [(f"backbone prefix {label}",
             lambda n=n: backbone(t["x_crop"], n_stages=n))
            for n, label in PREFIXES]


def chunk_rows(engine, state, t: dict, device, n_frames: int = CHUNK_T):
    """[(name, fn)] of the chunk rows over `n_frames` frames: the step
    loop without the freeze select, `_chunk` (with it), `run_chunk`
    donating and not."""
    from usot_tpu_torch.tracker.engine import _freeze_invalid

    b = t["pos"].shape[0]
    gen = torch.Generator(device=device).manual_seed(1)
    frames = torch.randint(0, 255, (n_frames, b, H, W, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    valid = torch.ones((n_frames, b), dtype=torch.bool, device=device)
    origin = torch.zeros((b, 2), device=device)
    engine._avg_b, engine._im_hw_b = t["avg"], t["hw"]

    def loop(select):
        def fn():
            carry, outs = state, []
            for i in range(n_frames):
                new, out = engine._frame_step_batched(
                    carry, frames[i], valid[i], t["avg"], t["hw"], origin)
                carry = _freeze_invalid(new, carry, valid[i]) if select \
                    else new
                outs.append(out[0])
            return torch.stack(outs)
        return fn

    return [("chunk loop, no select", loop(False)),
            ("chunk loop, with select (_chunk)", loop(True)),
            ("engine run_chunk, no donate",
             lambda: engine.run_chunk(state, frames, valid, donate=False)),
            ("engine run_chunk, donate",
             lambda: engine.run_chunk(state, frames, valid, donate=True))]


def increments(rows: list, dtype: str) -> list:
    """Per-stage rows from the cumulative backbone prefixes: each prefix
    less the one before (device ms, operations); the bound's bytes are
    the stage's alone: its input (the shorter prefix's output, read),
    its weights and its output (the longer prefix's bytes less the
    shorter's, plus twice the shorter's output)."""
    pref = [r for r in rows if r["stage"].startswith("backbone prefix")]
    out = []
    for a, b in zip(pref[:-1], pref[1:]):
        if not (a["device_ms"] and b["device_ms"]) \
                or b["device_ms"] <= a["device_ms"]:
            continue
        ms = b["device_ms"] - a["device_ms"]
        gflop = b["gflop"] - a["gflop"]
        mb = b["min_mb"] - a["min_mb"] + 2 * a["out_bytes"] / 1e6
        row = {"stage": b["stage"].replace("backbone prefix ",
                                           "backbone stage "),
               "device_ms": ms, "call_ms": None, "gflop": gflop,
               "min_mb": mb, "op_mb": b["op_mb"] - a["op_mb"]}
        row.update(sc.roofline(gflop * 1e9, mb * 1e6, ms, dtype))
        out.append(row)
    return out


def print_line(rec: dict):
    print(f"{rec['stage']:34s} {sc.fmt(rec['device_ms']):>12s} device ms  "
          f"{sc.fmt(rec['call_ms']):>10s} eager ms  K1 "
          f"{rec['launches']['K1']} K3 {rec['launches']['K3']}", flush=True)


def mfu_table(rows: list, batch: int, dtype: str, card: str) -> str:
    lines = [f"\n### Inference-step roofline attribution (B={batch}, "
             f"{dtype}, {card}; peaks: 989 TFLOP/s bf16 tensor, 67 TFLOP/s "
             "fp32, 3.35 TB/s HBM)\n",
             "| stage | device ms | eager ms | GFLOP | bound MB | op MB "
             "| TFLOP/s | GB/s | bound ms | bound | share |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        share = r.get("share_pct")
        lines.append(
            f"| {r['stage'].strip()} | {sc.fmt(r['device_ms'], '.4f')} | "
            f"{sc.fmt(r['call_ms'], '.4f')} | {r['gflop']:.2f} | "
            f"{r['min_mb']:.2f} | {r['op_mb']:.1f} | "
            f"{sc.fmt(r.get('tflops'), '.1f')} | {sc.fmt(r.get('gbps'), '.0f')} "
            f"| {r['bound_ms']:.4f} | {r['bound']} | "
            f"{sc.fmt(share, '.1f')}{'' if share is None else ' %'} |")
    return "\n".join(lines)


def run(args, weights=None, mfu_path: str = "var/mfu_inference.json"):
    """The tool on parsed `args`; `weights` (a state dict) instead of
    `load_weights`. Returns the record."""
    if args.s2d or args.s2b:
        raise ValueError("--s2d / --s2b name TPU layout rewrites of the "
                         "stem and layer3 that the port leaves out")
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    if args.only_prefix:
        args.mfu = True
    device, card = sc.open_device(args)
    dtype_t = sc.DTYPES[args.dtype]
    b = args.batch
    rec = {"tool": "microbench_step", "card": card, "device": str(device),
           "batch": b, "dtype": args.dtype, "iters": args.iters,
           "max_frames": args.max_frames, "stages": [], "chunk": [],
           "vmap": VMAP_NOTE}
    with torch.inference_mode():
        model = sc.load_model(args, device, args.dtype, weights)
        p = tracker_config()
        t = to_device(make_inputs(b, args.max_frames, args.channels),
                      dtype_t, device)
        engine = BatchScanEngine(model, p, H, W, batch=b,
                                 max_frames=args.max_frames, chunk=8,
                                 device=device)
        todo = [] if args.only_prefix else stages(model, engine, t, p)
        if args.mfu:
            todo += prefix_stages(model, t)
        for name, fn in todo:
            r = sc.measure(name, fn, device, args.dtype, args.iters, b)
            print_line(r)
            rec["stages"].append(r)
            if name.startswith("FULL STEP"):
                print(f"{'FULL STEP (vmap)':34s} {VMAP_NOTE}", flush=True)
        if not args.only_prefix:
            state = engine_state(model, t)
            for name, fn in chunk_rows(engine, state, t, device):
                ms = sc.events_ms(fn, device)
                per = None if ms is None else ms / CHUNK_T
                print(f"{name:34s} {sc.fmt(per):>12s} ms/frame (events)",
                      flush=True)
                rec["chunk"].append({"stage": name, "ms_per_frame": per,
                                     "frames": CHUNK_T})
    if args.mfu:
        rows = rec["stages"] + increments(rec["stages"], args.dtype)
        rec["mfu_rows"] = rows
        print(mfu_table(rows, b, args.dtype, card), flush=True)
        sc.write_json(mfu_path, {"batch": b, "dtype": args.dtype,
                                 "card": card, "rows": rows})
        print(f"\nwrote {mfu_path}", flush=True)
    sc.write_json(args.json, rec)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--dtype", choices=sorted(sc.DTYPES), default="bf16")
    ap.add_argument("--s2d", action="store_true",
                    help="a TPU layout rewrite of the stem: raises")
    ap.add_argument("--s2b", action="store_true",
                    help="a TPU layout rewrite of layer3: raises")
    ap.add_argument("--mfu", action="store_true",
                    help="per-stage roofline table against the card's "
                    "peaks; writes var/mfu_inference.json")
    ap.add_argument("--only-prefix", action="store_true",
                    help="only the backbone prefix decomposition (implies "
                    "--mfu)")
    return sc.common_args(ap).parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
