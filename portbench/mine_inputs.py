"""The mining cell's inputs: PWCLite's weights, made on the device from
the configuration's `weights_seed`, and the traffic's videos, rendered
on the device from its `content_seed` and held as BGR uint8 frames in
host memory (decoded frames, as a miner's reader gives them), in an
order drawn from the run's seed.

Both are fixed for every run: drawn from the run's seed, the weights
set how salient the flows are, and with it whether `flow_to_bbox`
processes a mask at all (the host's largest cost): six seeds, each with
its own weights and videos, read 14.1-21.0 frames/s, a spread of 21 %
(one H100 80GB HBM3), the seed choosing the work. So every seed
gets the same videos and weights, and the seed deals the videos' order,
the DP's perturbations and the judged video.

Weights: one normal draw for every conv kernel (a `torch.Generator` on
the device), clipped at two standard deviations and scaled per kernel to
lecun-normal's std, sqrt(1 / fan_in) / 0.8796; biases 0 (flax's init,
as the program's `init_pwclite`); then the two convs that emit a flow
residual (`flow_estimators.predict_flow`, `context_networks.convs.6`)
times the configuration's `flow_gain`. Unscaled, random weights read
~1 px of max|flow| at 720p, and the adaptive loop would grow to 7 and
stay there; the gain puts a forward's max|flow| across the loop's
16 px threshold on some frames and under it on the rest
(PERF.md, the configuration's `loop`).

Videos: a textured background that pans at its video's speed, and one
or two textured objects on it, each moving on a triangle wave at its
own speed (whole inside the frame). The lengths, pans, object counts,
sizes and speeds are evenly spread over the traffic's ranges and dealt
to the videos; directions, phases and textures are drawn (all from the
content seed).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.pwclite import CONTEXT, param_shapes

LECUN_TRUNC = 0.87962566103423978
FLOW_CONVS = ("flow_estimators.predict_flow.0.weight",
              f"context_networks.convs.{len(CONTEXT)}.0.weight")


def flow_weights(seed: int, device) -> dict:
    """{name: float32 tensor on `device`}, ARFlow's key layout, gain 1."""
    shapes = param_shapes()
    gen = torch.Generator(device=device).manual_seed(seed)
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    total = sum(math.prod(shapes[k]) for k in kernels)
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    w, at = {}, 0
    for k in kernels:
        s = shapes[k]
        n = math.prod(s)
        std = math.sqrt(1.0 / (s[1] * s[2] * s[3])) / LECUN_TRUNC
        w[k] = (draw[at:at + n] * std).reshape(s)
        at += n
    return {k: w[k] if k in w else torch.zeros(s, device=device)
            for k, s in shapes.items()}


def with_gain(weights: dict, gain: float) -> dict:
    """`weights` with the flow-emitting convs times `gain`."""
    return {k: v * gain if k in FLOW_CONVS else v for k, v in weights.items()}


def video_plans(rng: np.random.Generator, tr: dict) -> list:
    """One plan per video of the traffic's `lengths`: its length, pan
    (px a frame, signed) and objects (size (w, h), speed (vx, vy), phase),
    dealt from the traffic's fixed sets in an order drawn from `rng`."""
    n = len(tr["lengths"])
    h, w = tr["frame"]
    counts = [tr["objects"][i % len(tr["objects"])] for i in range(n)]
    n_obj = sum(counts)
    pans = np.linspace(*tr["pan_px"], n)
    speeds = np.linspace(*tr["speed_px"], n_obj)
    sizes = np.linspace(*tr["object_frac"], n_obj)
    deal = rng.permutation(n)
    obj_deal = rng.permutation(n_obj)
    plans, k = [], 0
    for v in deal:
        objects = []
        for _ in range(counts[v]):
            j = obj_deal[k]
            k += 1
            ow = int(round(sizes[j] * w))
            oh = int(round(sizes[n_obj - 1 - j] * h))
            angle = rng.uniform(0, 2 * math.pi)
            objects.append(dict(size=(ow, oh), speed=(
                speeds[j] * math.cos(angle), speeds[j] * math.sin(angle)),
                phase=rng.uniform(0, 1, 2)))
        plans.append(dict(length=int(tr["lengths"][v]),
                          pan=float(pans[v] * rng.choice([-1, 1])),
                          objects=objects))
    return plans


def _texture(gen, h, w, lo, span, device):
    """Uniform noise at 1/16 of the size upsampled bilinearly, plus
    grain: (h, w, 3) float32."""
    coarse = torch.rand((1, 3, h // 16 + 2, w // 16 + 2), generator=gen,
                        device=device)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False)[0].permute(1, 2, 0)
    return lo + span * smooth + 30 * torch.rand((h, w, 3), generator=gen,
                                                device=device)


def _wave(start, speed, t, room):
    """Positions at frames t of a point moving at `speed` from `start`
    and reflected at 0 and `room` (a triangle wave)."""
    if room <= 0:
        return np.zeros_like(t, dtype=np.int64)
    x = np.mod(start + speed * t, 2 * room)
    return np.rint(np.where(x > room, 2 * room - x, x)).astype(np.int64)


def render(plan: dict, seed: int, index: int, h: int, w: int,
           device) -> list:
    """The video's frames, (h, w, 3) BGR uint8 numpy arrays, made on
    `device` 32 at a time."""
    gen = torch.Generator(device=device).manual_seed(seed + 7919 * index)
    n, pan = plan["length"], plan["pan"]
    reach = int(math.ceil(abs(pan) * (n - 1)))
    bg = _texture(gen, h, w + reach, 20, 150, device)
    t = np.arange(n)
    offset = np.rint((reach if pan < 0 else 0) + pan * t).astype(np.int64)
    objs = []
    for o in plan["objects"]:
        ow, oh = o["size"]
        tex = _texture(gen, oh, ow, 60, 170, device)
        xs = _wave(o["phase"][0] * 2 * (w - ow), o["speed"][0], t, w - ow)
        ys = _wave(o["phase"][1] * 2 * (h - oh), o["speed"][1], t, h - oh)
        objs.append((tex, xs, ys))
    frames = []
    for f0 in range(0, n, 32):
        block = []
        for f in range(f0, min(n, f0 + 32)):
            im = bg[:, offset[f]:offset[f] + w].clone()
            for tex, xs, ys in objs:
                oh, ow = tex.shape[:2]
                im[ys[f]:ys[f] + oh, xs[f]:xs[f] + ow] = tex
            block.append(im)
        block = torch.stack(block).clamp_(0, 255).to(torch.uint8).cpu()
        frames.extend(block.numpy())
    return frames


def make_videos(seed: int, tr: dict, device) -> list:
    """[(plan, frames)] of the traffic's videos (from its
    `content_seed`), in an order drawn from `seed`."""
    content = tr["content_seed"]
    plans = video_plans(np.random.default_rng([content, 3]), tr)
    h, w = tr["frame"]
    videos = [(p, render(p, content, i, h, w, device))
              for i, p in enumerate(plans)]
    return [videos[i] for i in
            np.random.default_rng([seed, 3]).permutation(len(videos))]
