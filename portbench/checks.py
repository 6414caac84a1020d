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
