"""The comparisons that decide `correct`, shared by the drivers.

Tracking (`track_checks`): the reference tracker (`reference/tracker.py`)
follows a sample of the program's lanes frame by frame from the
program's own outputs and reads, per frame, how far the program's
chosen cell lies below the reference's best (`gap`), how far its box is
from that cell's (`box_px`) and its score from the cell's (`score`);
the statistics of these over the sample that the configuration's
limits name are held to them (statistics: mean, p90, p99, max).

Training (`train_numbers`): the reference follows the first steps from
the same weights and batches. The relative gap of the first step's
total loss (`loss_step1`; a later step's loss can sit where a rounding
of the step before moves it by hundreds of ulps, so it is logged, not
held); by the worst leaf, the gap between the program's norm and the
reference's, over the larger of the reference leaf's norm and the
median leaf's: of the first gradient (`grad`), of each parameter's
change over the steps (`change`; leaves whose first reference gradient
is under 1e-3 of the median leaf's, which move by round-off alone, are
left out), and of each BN statistic's change (`stats`).
"""
from __future__ import annotations

import numpy as np
import torch


STATS = {"mean": np.mean, "max": np.max,
         "p90": lambda v: np.percentile(v, 90),
         "p99": lambda v: np.percentile(v, 99)}


def track_checks(readings: dict, limits: dict) -> dict:
    """{`<reading>_<statistic>`: (that statistic of the reading over the
    judged frames, its limit)} for each limit the configuration names
    (statistics: mean, p90, p99, max)."""
    out = {}
    for name, limit in limits.items():
        reading, stat = name.rsplit("_", 1)
        out[name] = (float(STATS[stat](readings[reading])), float(limit))
    return out


def spread(readings: dict) -> str:
    """The readings' median, 90th and 99th percentiles, mean and largest,
    for the log."""
    return "; ".join(
        f"{k} p50 {np.percentile(v, 50):.6g} p90 {np.percentile(v, 90):.6g}"
        f" p99 {np.percentile(v, 99):.6g} mean {np.mean(v):.6g} max "
        f"{np.max(v):.6g} n {np.size(v)}" for k, v in readings.items())


def _norms(tensors: dict, keys) -> dict:
    return {k: float(torch.linalg.vector_norm(tensors[k].double()))
            for k in keys}


def worst_leaf(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref),
    median leaf's norm(ref)), and that leaf."""
    keys = list(keys)
    rn, pn = _norms(ref, keys), _norms(prog, keys)
    med = float(np.median(list(rn.values())))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_numbers(prog: dict, ref: dict, start: dict) -> dict:
    """prog / ref: {"loss": [per step total], "grad1": {leaf: tensor},
    "params": {leaf: tensor}, "stats": {stat: tensor}}; start: the
    weights both began from. Returns {name: (number, worst leaf)}."""
    lp, lr = float(prog["loss"][0]), float(ref["loss"][0])
    loss = abs(lp - lr) / max(abs(lr), 1e-30)
    gn = _norms(ref["grad1"], ref["grad1"])
    med = float(np.median(list(gn.values())))
    moving = [k for k in ref["grad1"] if gn[k] >= 1e-3 * med]
    d_prog = {k: prog["params"][k] - start[k] for k in moving}
    d_ref = {k: ref["params"][k] - start[k] for k in moving}
    s_prog = {k: prog["stats"][k] - start[k] for k in ref["stats"]}
    s_ref = {k: ref["stats"][k] - start[k] for k in ref["stats"]}
    return {"loss_step1": (loss, ""),
            "grad": worst_leaf(prog["grad1"], ref["grad1"], ref["grad1"]),
            "change": worst_leaf(d_prog, d_ref, moving),
            "stats": worst_leaf(s_prog, s_ref, ref["stats"])}


def mine_numbers(prog: dict, ref: dict, frames: list, cfg: dict,
                 device) -> tuple[dict, str]:
    """The mining check of one judged video. prog: the program's
    "decisions" [(frame, interval, max|flow|)], "mined" (inference_
    sequence's (boxes, picked, stats), or None where it dropped the
    video) and "crops" {path: crop}; ref: `reference.mining.replay`'s.
    Numbers: `maxflow_rel`, the largest |program - reference| / reference
    of a forward's max|flow|; `decision_flips`, the forwards after which
    the reference's rule on its own max|flow| takes another step than
    the program took, where the reference's margin from 8 and 16 px
    exceeds 100 times the two's gap (a sampled frame missing from or
    added to the program's loop counts as one); `box_px_<stat>`, the
    statistic the configuration names of the per-frame largest
    coordinate gap between the program's boxes and the reference's DP
    (infinite where one side mined no box); `crop_levels_max`, the
    largest grey-level gap between the program's crops and the
    reference's at the program's boxes (infinite where a crop is
    missing). Returns ({name: number}, the readings for the log)."""
    from portbench.reference.mining import (GROW_BELOW, SHRINK_ABOVE,
                                            crop_x, next_interval)

    gap, limits = cfg["mining"]["gap"], cfg["limits"]["mine_videos"]
    dec, ref_max = prog["decisions"], ref["maxflow"]
    rel = [abs(d[2] - r) / max(r, 1e-30) for d, r in zip(dec, ref_max)]
    flips, direction = 0, 0
    for k, ((i, interval, m), r) in enumerate(zip(dec, ref_max)):
        nxt = dec[k + 1] if k + 1 < len(dec) and dec[k + 1][0] == i else None
        took = None if nxt is None else (nxt[1], 1 if nxt[1] > interval
                                         else -1)
        margin = min(abs(r - GROW_BELOW), abs(r - SHRINK_ABOVE))
        if next_interval(r, interval, direction) != took \
                and margin > 100 * abs(m - r):
            flips += 1
        direction = 0 if took is None else took[1]
    n = len(frames)
    flips += len(set(ref["sampled"]) ^ set(range(gap, n - gap, gap)))

    numbers = {"maxflow_rel": max(rel, default=0.0),
               "decision_flips": float(flips)}
    mined, rmined = prog["mined"], ref["mined"]
    if mined is None or rmined is None:
        box = np.array([0.0 if mined is None and rmined is None
                        else np.inf])
    else:
        box = np.abs(np.asarray(mined[0], np.float64)
                     - np.asarray(rmined[0], np.float64)).max(axis=1)
    crop = [0.0]
    if mined is not None:
        by_frame = {int(p.rsplit("/", 1)[-1][:6]): c
                    for p, c in prog["crops"].items()}
        size = cfg["mining"]["instance_size"]
        for f, b in enumerate(mined[0]):
            if f not in by_frame:
                crop.append(np.inf)
                continue
            want = crop_x(torch.from_numpy(frames[f]).to(device), b, size)
            got = torch.from_numpy(by_frame[f]).to(device)
            crop.append(float((got.int() - want.int()).abs().max()))
    box_stats = {k: float(f(box)) if np.isfinite(box).all() else np.inf
                 for k, f in STATS.items()}
    for name in limits:
        if name.startswith("box_px_"):
            numbers[name] = box_stats[name.rsplit("_", 1)[1]]
    numbers["crop_levels_max"] = max(crop)
    same = mined is not None and rmined is not None
    readings = (
        f"forwards {len(dec)}; maxflow program "
        f"{np.round([d[2] for d in dec], 4).tolist()}; maxflow_rel p50 "
        f"{np.median(rel) if rel else 0:.3g} max "
        f"{numbers['maxflow_rel']:.3g}; flips {flips}; box_px p50 "
        f"{np.median(box):.4g} p90 {box_stats['p90']:.4g} max "
        f"{box_stats['max']:.4g}; picked equal "
        f"{same and list(mined[1]) == list(rmined[1])}; found, picked, "
        f"vary program {None if mined is None else mined[2][1:4]} "
        f"reference {None if rmined is None else rmined[2:5]}; crops "
        f"{len(prog['crops'])}, largest gap {max(crop)}")
    return numbers, readings
