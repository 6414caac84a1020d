"""Device-time A/B of the memory-ring formulations at bench shapes on one
GPU (the counterpart of `tools/bench_memops.py`).

    python -m usot_tpu_torch.tools.bench_memops [--batch 32] [--slots 257]
        [--frames 64] [--iters 20] [--k 5] [--channels 256]
        [--device cpu] [--json PATH]

Three bf16 rings of (5, 5), (3, 5) and (5, 3) x C maps, B lanes of S + 1
slots (the last the scratch slot of invalid-frame writes), K picks per
frame. Formulations:

gather:
  take    - the engine's `_gather_slots` (`index_select` of the lanes'
            flattened slots)
  onehot  - a one-hot einsum over the slot axis (streams every ring)
write:
  scatter - the engine's `_scatter_slots` (`index_copy_` of each lane's
            slot; an invalid lane writes its scratch slot)
  shared  - one block write of (B, 1, h, w, C) into the slot every lane
            shares (the lockstep regime before a ring fills), an invalid
            lane blended back to its old content

Each of the 4 combinations runs as one T-frame loop (gather, fold the
gathered queue into the written features with weight 0, write),
captured in one CUDA graph (`timing.time_device_ms`, `--iters` replays)
and reported per frame, beside the bytes a frame must move and their
time at 3.35 TB/s. Then the correctness block of the JAX tool, bitwise:
take == onehot; scatter == shared on a shared slot; with diverged slots
and invalid lanes the guarded shared write agrees with the scatter; an
invalid lane keeps its old content.

Deviation: JAX's `shared` falls back to the scatter inside the program
(`lax.cond`) when the lanes' slots differ. The port cannot branch on
device data without a host sync (`tracker/engine.py`'s ring write says
so), so the timed `shared` is the lockstep regime's block write alone;
`write_shared(..., guard=True)` makes the check on the host, for the
correctness block only. Runs on the GPU unless `--device cpu` is given
(no device time there).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from usot_tpu_torch.models.head import SCALES as DILATIONS
from usot_tpu_torch.tools import stage_cost as sc
from usot_tpu_torch.tracker.engine import _gather_slots, _scatter_slots

# each ring's slot: a 7x7 memory feature through its scale's dilated 3x3
# VALID encoder conv: (5, 5), (3, 5), (5, 3)
SCALES = tuple((7 - 2 * dh, 7 - 2 * dw) for _, (dh, dw) in DILATIONS)


def gather_take(rings, picks):
    """picks (B, K) -> [(B, K, h, w, C)] per ring."""
    return [_gather_slots(r, picks) for r in rings]


def gather_onehot(rings, picks):
    """The one-hot einsum over all S' slots of every ring."""
    oh = torch.nn.functional.one_hot(picks.long(), rings[0].shape[1]) \
        .to(rings[0].dtype)                                  # (B, K, S')
    out = []
    for r in rings:
        b, s = r.shape[:2]
        g = torch.einsum("bks,bsf->bkf", oh, r.reshape(b, s, -1))
        out.append(g.reshape((b, picks.shape[1]) + tuple(r.shape[2:])))
    return out


def write_scatter(rings, feats, slot_b, valid_b):
    """feats[i] (B, 1, h, w, C) into slot_b (B,) of each lane, in place;
    an invalid lane writes its scratch slot (the last)."""
    s = rings[0].shape[1] - 1
    _scatter_slots(rings, feats, torch.where(valid_b, slot_b, s))
    return rings


def write_shared(rings, feats, slot_b, valid_b, guard: bool = False):
    """One block write into slot slot_b[0] of every lane, in place, an
    invalid lane's block its old content. Exact only when every lane's
    slot is slot_b[0]: guard=True checks that on the host (a sync) and
    takes `write_scatter` when it does not hold."""
    if guard and not bool((slot_b == slot_b[0]).all()):
        return write_scatter(rings, feats, slot_b, valid_b)
    s = slot_b[:1].long()
    for r, f in zip(rings, feats):
        old = r.index_select(1, s)                           # (B, 1, ...)
        mask = valid_b.reshape((-1,) + (1,) * (r.dim() - 1))
        r.index_copy_(1, s, torch.where(mask, f.to(r.dtype), old))
    return rings


GATHERS = {"take": gather_take, "onehot": gather_onehot}
WRITES = {"scatter": write_scatter, "shared": write_shared}


def make_data(batch, slots, frames, k, channels=256, seed=0,
              dtype=torch.bfloat16, device="cpu"):
    """Seeded rings (B, S + 1, h, w, C), per-frame features (T, B, 1, h,
    w, C), picks (T, B, K) in [0, S), one write slot per frame shared by
    every lane (the lockstep regime) and all lanes valid, as the JAX
    tool draws them; and the numpy arrays they came from."""
    rng = np.random.default_rng(seed)
    b, s, t, c = batch, slots, frames, channels
    host = {
        "rings": [rng.standard_normal((b, s + 1, h, w, c), np.float32)
                  for h, w in SCALES],
        "feats": [rng.standard_normal((t, b, 1, h, w, c), np.float32)
                  for h, w in SCALES],
        "picks": rng.integers(0, s, size=(t, b, k)).astype(np.int32),
        "slots": np.repeat(rng.integers(0, s, size=(t,))[:, None], b,
                           axis=1).astype(np.int32),
        "slot_div": rng.integers(0, s, size=(b,)).astype(np.int32),
        "val_mix": rng.integers(0, 2, size=(b,)).astype(bool)}

    def put(a, cast=True):
        x = torch.from_numpy(a).to(device)
        return x.to(dtype) if cast and x.is_floating_point() else x

    dev = {"rings": [put(a) for a in host["rings"]],
           "feats": [put(a) for a in host["feats"]],
           "picks": put(host["picks"]).long(),
           "slots": put(host["slots"]).long(),
           "valid": torch.ones((t, b), dtype=torch.bool, device=device),
           "slot_div": put(host["slot_div"]).long(),
           "val_mix": put(host["val_mix"])}
    return dev, host


def frame_loop(gname, wname, rings, d):
    """fn of no arguments: the T-frame loop of one combination on
    `rings` (written in place). Returns the per-frame readouts."""
    gfn, wfn = GATHERS[gname], WRITES[wname]

    def fn():
        outs = []
        for t in range(d["picks"].shape[0]):
            q = gfn(rings, d["picks"][t])
            # the gathered queue folded in with weight 0: neither op is
            # dead, the traffic is the same
            fs = [f[t] + g.mean(dim=1, keepdim=True) * 0
                  for f, g in zip(d["feats"], q)]
            wfn(rings, fs, d["slots"][t], d["valid"][t])
            outs.append(q[0][:, 0, 0, 0, 0].float().sum())
        return torch.stack(outs)
    return fn


def frame_bytes(rings, k: int) -> dict:
    """Bytes one frame must move: a gather reads K slots and writes them;
    a write reads one slot's features and writes them; the one-hot reads
    every ring whole."""
    slot = sum(r[0, 0].numel() * r.element_size() for r in rings)
    b = rings[0].shape[0]
    return {"take": 2 * k * slot * b, "onehot":
            sum(r.numel() * r.element_size() for r in rings)
            + k * slot * b, "scatter": 2 * slot * b, "shared": 2 * slot * b}


def correctness(d) -> None:
    """The JAX tool's cross-checks, bitwise (raises on a mismatch)."""
    def fresh():
        return [r.clone() for r in d["rings"]]

    def same(a, b, what):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"memops: {what} differ")

    same(gather_take(d["rings"], d["picks"][0]),
         gather_onehot(d["rings"], d["picks"][0]), "take and onehot")
    f0 = [f[0] for f in d["feats"]]
    same(write_scatter(fresh(), f0, d["slots"][0], d["valid"][0]),
         write_shared(fresh(), f0, d["slots"][0], d["valid"][0]),
         "scatter and shared on a shared slot")
    same(write_scatter(fresh(), f0, d["slot_div"], d["val_mix"]),
         write_shared(fresh(), f0, d["slot_div"], d["val_mix"], guard=True),
         "scatter and guarded shared on diverged slots")
    w3 = write_shared(fresh(), f0, d["slots"][0], d["val_mix"])
    s0 = int(d["slots"][0, 0])
    keep = ~d["val_mix"]
    for r0, w in zip(d["rings"], w3):
        if not torch.equal(w[keep, s0], r0[keep, s0]):
            raise AssertionError("memops: an invalid lane's slot changed")


def run(args):
    device, card = sc.open_device(args)
    b, s, t, k = args.batch, args.slots, args.frames, args.k
    d, _ = make_data(b, s, t, k, args.channels, device=device)
    ring_mb = sum(r.numel() * r.element_size() for r in d["rings"]) / 1e6
    print(f"B={b} S={s} T={t} K={k} C={args.channels} ring MB={ring_mb:.1f}",
          flush=True)
    per_frame = frame_bytes(d["rings"], k)
    rec = {"tool": "bench_memops", "card": card, "device": str(device),
           "batch": b, "slots": s, "frames": t, "k": k,
           "channels": args.channels, "ring_mb": ring_mb, "rows": []}
    with torch.inference_mode():
        for gname in GATHERS:
            for wname in WRITES:
                rings = [r.clone() for r in d["rings"]]
                fn = frame_loop(gname, wname, rings, d)
                ms = None
                if device.type == "cuda":
                    from usot_tpu_torch.tools.timing import time_device_ms

                    ms = time_device_ms(fn, inner=1, reps=args.iters) / t
                else:
                    fn()
                nbytes = per_frame[gname] + per_frame[wname]
                bound = nbytes / sc.PEAK_BYTES_PER_S * 1e3
                rec["rows"].append({
                    "gather": gname, "write": wname, "ms_per_frame": ms,
                    "bytes_per_frame": nbytes, "bound_ms": bound,
                    "share_pct": None if ms is None else 100 * bound / ms})
                shown = "not measured" if ms is None else f"{ms:.4f}"
                print(f"  gather={gname:6s} write={wname:7s}: {shown} "
                      f"ms/frame ({nbytes / 1e6:.2f} MB, bound "
                      f"{bound * 1e3:.2f} us)", flush=True)
        correctness(d)
    rec["correct"] = True
    print("correctness: all formulations agree", flush=True)
    sc.write_json(args.json, rec)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--slots", type=int, default=257)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--k", type=int, default=5, help="picks per frame")
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                    "one). `cpu` runs on the CPU")
    ap.add_argument("--json", default=None,
                    help="write the record to this path")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
