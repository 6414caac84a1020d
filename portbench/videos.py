"""Seeded synthetic videos, made on the device (the recipe of the port's
`synthetic_video`, copied and widened per lane): a uniform-noise frame
per video, and on it a solid box of the video's own size and colour
whose centre moves on a triangle wave of the video's own speed and
phase, always whole inside the frame. The same seed gives the same
frames on every run.
"""
from __future__ import annotations

import numpy as np
import torch

PERIOD = 64  # frames of one triangle-wave cycle


def lane_plans(rng: np.random.Generator, lanes: int, h: int, w: int,
               box_px, speed_px) -> list:
    """Per lane: box size (bw, bh), colour, centre at the wave's foot
    (cx, cy) and velocity (vx, vy) in px per frame. The sizes and speeds
    are one fixed set for every seed (evenly spaced over `box_px` and
    `speed_px`; a lane's height from the set in the reverse order of
    its width), dealt to the lanes in an order drawn from the seed: the
    host's crops of a lane cost by its box's size, so every seed gets
    the same work. Colours, centres, directions and phases are drawn."""
    sizes = np.rint(np.linspace(box_px[0], box_px[1], lanes)).astype(int)
    speeds = np.linspace(speed_px[0], speed_px[1], lanes)
    deal = rng.permutation(lanes)
    plans = []
    for i in deal:
        bw, bh = int(sizes[i]), int(sizes[lanes - 1 - i])
        v = np.array([speeds[i], speeds[lanes - 1 - i]]) \
            * rng.choice([-1, 1], 2)
        reach = np.abs(v) * PERIOD / 2          # the wave's excursion
        lo = np.array([bw, bh]) / 2 + 2 + np.where(v < 0, reach, 0)
        hi = np.array([w, h]) - np.array([bw, bh]) / 2 - 2 \
            - np.where(v > 0, reach, 0)
        c = rng.uniform(lo, hi)
        plans.append(dict(size=(bw, bh), colour=rng.integers(0, 256, 3),
                          centre=c, velocity=v,
                          phase=int(rng.integers(0, PERIOD))))
    return plans


def box_at(plan: dict, f: int):
    """Integer box [x0, y0, x1, y1) of the lane's target in frame f."""
    half = PERIOD // 2
    tri = half - abs((f + plan["phase"]) % PERIOD - half)
    cx, cy = plan["centre"] + plan["velocity"] * tri
    bw, bh = plan["size"]
    x0, y0 = int(round(cx - bw / 2)), int(round(cy - bh / 2))
    return x0, y0, x0 + bw, y0 + bh


def render(plans: list, seed: int, frames: int, h: int, w: int, device):
    """(video (frames, lanes, h, w, 3) uint8 on `device`, frame-major;
    the targets' centres (lanes, 2) and sizes (lanes, 2) in frame 0,
    float64 numpy) of `plans`, on noise drawn from `seed`."""
    lanes = len(plans)
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randint(0, 256, (lanes, h, w, 3), generator=gen,
                         dtype=torch.uint8, device=device)
    video = base.unsqueeze(0).expand(frames, -1, -1, -1, -1).clone()
    del base
    colours = torch.as_tensor(np.stack([p["colour"] for p in plans]),
                              dtype=torch.uint8, device=device)
    for f in range(frames):
        for i, plan in enumerate(plans):
            x0, y0, x1, y1 = box_at(plan, f)
            video[f, i, y0:y1, x0:x1] = colours[i]
    first = [box_at(p, 0) for p in plans]
    pos = np.array([[(x0 + x1) / 2, (y0 + y1) / 2]
                    for x0, y0, x1, y1 in first], np.float64)
    sz = np.array([p["size"] for p in plans], np.float64)
    return video, pos, sz


def make_videos(seed: int, lanes: int, frames: int, h: int, w: int,
                box_px, speed_px, device):
    """`lanes` videos of `frames` frames (see `render`)."""
    plans = lane_plans(np.random.default_rng(seed), lanes, h, w, box_px,
                       speed_px)
    return render(plans, seed, frames, h, w, device)
