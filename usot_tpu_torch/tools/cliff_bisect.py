"""Composition bisect of the memory head for a per-step cliff on one GPU
(the counterpart of `tools/cliff_bisect.py`, companion of
`cliff_sweep`).

    python -m usot_tpu_torch.tools.cliff_bisect --batch 64
        [--chains A,B,C,D,E,F] [--iters 20] [--dtype bf16|f32]
        [--device cpu] [--json PATH] [--ckpt PATH] [--width 64]
        [--channels 256]

Incrementally longer chains of `BoxTowerReg`'s memory head, so that a
jump localizes to one composition step:

  A  encode_search                (6 encoder convs)
  B  A + cls_dw + reg_dw          (the offline template correlations)
  C  B + towers + preds           (= `offline_preenc`)
  D  C + `GroupDW.multi`          (the memory correlations, K1 at M=7)
  E  D + ConfFusion + memory tower (= `track_memory_encoded_batched`)
  F  E on `build_usot(fused_xcorr=True)`: the offline pair correlations
     go through K1 too

A-E run the model with `fused_xcorr=False`, as JAX's tool builds its
model: its pair correlations are the grouped convolution
(`ops/xcorr.xcorr_depthwise`, cuDNN), and so are E's memory
correlations, on the search encodings repeated to B*M lanes; D calls
`GroupDW.multi` (K1) itself. F is the card's production path. Readouts are
full-tensor means (`tools/cliff_bisect.py:3-8`). Per chain: device ms per
iteration (a CUDA graph of `--iters` calls) beside the eager call, GFLOP
and MB per iteration (`stage_cost`). Inputs as `microbench_step`'s.
Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse

import torch

from usot_tpu_torch.tools import microbench_step as mb
from usot_tpu_torch.tools import stage_cost as sc

CHAINS = "ABCDEF"


def _mean(*tensors):
    return sum(t.float().mean() for t in tensors)


def chain_fns(model, model_fused, t: dict) -> dict:
    """{chain: fn of no arguments returning the chain's readout} on the
    device inputs `t`; the kernel side is encoded by `model`."""
    xf, queue_enc = t["xf"], tuple(t["queue_enc"])
    zf_enc = model.encode_template(t["zf"])

    def a(m):
        cx, rx = m.connect_model.encode_search(xf)
        return _mean(*cx, *rx)

    def b(m):
        head = m.connect_model
        cx, rx = head.encode_search(xf)
        return _mean(head.cls_dw(list(zf_enc[0]), cx),
                     head.reg_dw(list(zf_enc[1]), rx))

    def c(m):
        bbox, cls, _, _ = m.connect_model.offline_preenc(
            xf, list(zf_enc[0]), list(zf_enc[1]))
        return _mean(cls, bbox)

    def d(m):
        head = m.connect_model
        bbox, cls, cls_x, _ = head.offline_preenc(
            xf, list(zf_enc[0]), list(zf_enc[1]))
        bq, n_q = queue_enc[0].shape[:2]
        flat = [q.reshape((bq * n_q,) + tuple(q.shape[2:]))
                for q in queue_enc]
        return _mean(cls, bbox, head.cls_dw.multi(flat, cls_x, n_q))

    def e(m):
        cls, bbox, cls_mem = m.track_memory_encoded_batched(xf, zf_enc,
                                                            queue_enc)
        return _mean(cls, cls_mem, bbox)

    return {"A": lambda: a(model), "B": lambda: b(model),
            "C": lambda: c(model), "D": lambda: d(model),
            "E": lambda: e(model), "F": lambda: e(model_fused)}


def run(args, weights=None) -> dict:
    chains = [s.strip().upper() for s in args.chains.split(",")
              if s.strip()]
    unknown = set(chains) - set(CHAINS)
    if unknown:
        raise ValueError(f"unknown chains {sorted(unknown)}")
    device, card = sc.open_device(args)
    b = args.batch
    rec = {"tool": "cliff_bisect", "card": card, "device": str(device),
           "batch": b, "dtype": args.dtype, "iters": args.iters,
           "chains": []}
    with torch.inference_mode():
        if weights is None:
            from usot_tpu_torch.tools.bench import load_weights

            weights = load_weights(args.ckpt, device)[0]
        model = sc.load_model(args, device, args.dtype, weights,
                              fused_xcorr=False)
        fused = sc.load_model(args, device, args.dtype, weights)
        t = mb.to_device(mb.make_inputs(b, 8, args.channels),
                         sc.DTYPES[args.dtype], device)
        fns = chain_fns(model, fused, t)
        for name in chains:
            r = sc.measure(f"chain {name}", fns[name], device, args.dtype,
                           args.iters, b)
            r["readout"] = float(fns[name]())
            print(f"B={b} chain {name}   {sc.fmt(r['device_ms']):>12s} "
                  f"ms/iter (eager {r['call_ms']:.3f})  {r['gflop']:8.2f} "
                  f"GFLOP/iter  {r['min_mb']:8.1f} MB/iter bound, "
                  f"{r['op_mb']:8.1f} op  K1 {r['launches']['K1']}",
                  flush=True)
            rec["chains"].append(r)
    sc.write_json(args.json, rec)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--chains", default=",".join(CHAINS))
    ap.add_argument("--dtype", choices=sorted(sc.DTYPES), default="bf16")
    return sc.common_args(ap).parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
