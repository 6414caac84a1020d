"""OSTrack in plain PyTorch and NumPy, written from the published
description and code (Ye et al., "Joint Feature Learning and Relation
Modeling for Tracking: A One-Stream Framework", ECCV 2022, arXiv
2203.11991; github.com/botaoye/OSTrack `lib/models/ostrack/vit_ce.py`,
`utils.py`, `lib/models/layers/head.py`, `lib/test/tracker/ostrack.py`,
`lib/train/data/processing_utils.py::sample_target`): the ViT one-stream
backbone with candidate elimination, the centre head, the crop and the
tracker step. float32 (the caller turns TF32 off), no kernels, no cache:
attention is an explicit softmax whose probabilities are returned, and
candidate elimination reads them as OSTrack's `candidate_elimination`
does. Imports nothing of the measured program.

Weights are one dict, name -> tensor, in OSTrack's `net` state-dict
layout (`backbone.*`, `box_head.*`; BN statistics under `.running_mean`
/ `.running_var`). `SIZES` holds the published OSTrack-384 sizes
(`experiments/ostrack/vitb_384_mae_ce_32x4_ep300.yaml`); a smaller set
of the same keys gives a smaller model.

* Backbone: a 16-px patch embedding (a conv) of the template and of the
  search crop, each plus its own position table (`pos_embed_z`,
  `pos_embed_x`); the template tokens then the search tokens through
  `depth` pre-norm blocks (LayerNorm eps 1e-6, multi-head attention with
  a qkv bias, an MLP with exact GELU); a final LayerNorm.
* Candidate elimination in the blocks `ce_loc`: after the block's
  attention and residual add, the attention row of the template's centre
  token (row (t - 1) // 2, column (t - 1) // 2 of its t x t grid:
  `CE_TEMPLATE_RANGE: CTR_POINT`), softmax over all the block's tokens,
  averaged over the heads on the search columns, is sorted, and the
  search tokens of the top ceil(keep * L_s) are kept (in that sorted
  order) before the MLP. After the final norm the search tokens go back
  to their grid positions; dropped positions are zero.
* Head (`CenterPredictor`): three branches on the search map, each four
  3x3 conv-BN-ReLU layers (C -> c -> c/2 -> c/4 -> c/8) then a 1x1 conv:
  score (1), offset (2), size (2); score and size through a sigmoid
  clamped to [1e-4, 1 - 1e-4].
* Tracker: the crop `sample_target` (a square window of side
  ceil(sqrt(w h) * factor) at the box's centre, zero outside the image,
  resized to the model size), ImageNet normalisation; the score map times
  a centred Hann window, its argmax cell, the box ((x + off_x) / F,
  (y + off_y) / F, w, h) of the crop, mapped back to the frame around the
  previous box's centre and clipped (`clip_box`, margin 10). The
  template is never updated.

`sample_target` keeps a quirk of OSTrack's: its right and bottom pads are
`max(x2 - W + 1, 0)`, so the image's last column and last row read zero
whenever the window reaches them. The resize is OpenCV's INTER_LINEAR as
float32 arithmetic (half-pixel centres clamped at 0, two taps, the far
one clamped to the edge, rounded half up), within one grey level of
`cv2.resize`.

`Tracker.track` runs lanes in lockstep, free or (given a program's
outputs) following them: each frame is cropped at the program's previous
box; at each CE stage the reference ranks the search tokens itself,
counts the tokens of its own top set that the program dropped, and then
keeps the program's set (`stages`, the CE stages that kept each grid
position), so what follows is computed on the tokens the program kept;
every cell's outcome is computed, the program's cell is found from its
output (`match`), and four numbers are read per frame: `swaps`, the
tokens counted at the CE stages, summed over them; `gap`, the best
windowed score less the windowed score of the program's cell; `box_px`,
that cell's box against the program's, in frame pixels; `score`, the
program's score against that cell's raw score.

`q` (a function of a tensor) rounds the blocks' linear layers' inputs
and weights: a network computed in a lower precision (the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SIZES = dict(dim=768, depth=12, heads=12, mlp=3072, patch=16,
             template=192, search=384, head_channels=256, ce_loc=(3, 6, 9),
             keep=0.7, template_factor=2.0, search_factor=5.0)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
BN_EPS = 1e-5
MARGIN = 10
BRANCHES = (("ctr", 1), ("offset", 2), ("size", 2))


# ----------------------------------------------------------- parameters

def grid(s: dict, side: int) -> int:
    return side // s["patch"]


def centre_token(s: dict) -> int:
    """The template's centre token, flat: row and column (t - 1) // 2 of
    its t x t grid (OSTrack's table: 8 -> 3, 12 -> 5, 14 -> 6)."""
    t = grid(s, s["template"])
    c = (t - 1) // 2
    return c * t + c


def kept_counts(s: dict) -> list:
    """Search tokens kept at each candidate-elimination stage."""
    n, out = grid(s, s["search"]) ** 2, []
    for _ in s["ce_loc"]:
        n = math.ceil(s["keep"] * n)
        out.append(n)
    return out


def param_shapes(s: dict = SIZES) -> dict:
    """{name: shape} of every parameter and BN statistic the tracker
    uses, in OSTrack's state-dict layout."""
    d, p, c = s["dim"], s["patch"], s["head_channels"]
    shapes = {"backbone.patch_embed.proj.weight": (d, 3, p, p),
              "backbone.patch_embed.proj.bias": (d,),
              "backbone.pos_embed_z": (1, grid(s, s["template"]) ** 2, d),
              "backbone.pos_embed_x": (1, grid(s, s["search"]) ** 2, d)}
    for i in range(s["depth"]):
        b = f"backbone.blocks.{i}."
        for name, shape in (("norm1", (d,)), ("attn.qkv", (3 * d, d)),
                            ("attn.proj", (d, d)), ("norm2", (d,)),
                            ("mlp.fc1", (s["mlp"], d)),
                            ("mlp.fc2", (d, s["mlp"]))):
            shapes[b + name + ".weight"] = shape
            shapes[b + name + ".bias"] = (shape[0],)
    shapes["backbone.norm.weight"] = (d,)
    shapes["backbone.norm.bias"] = (d,)
    for branch, out in BRANCHES:
        cin = d
        for k in range(1, 5):
            cout = c // 2 ** (k - 1)
            h = f"box_head.conv{k}_{branch}."
            shapes[h + "0.weight"] = (cout, cin, 3, 3)
            shapes[h + "0.bias"] = (cout,)
            for stat in ("weight", "bias", "running_mean", "running_var"):
                shapes[h + "1." + stat] = (cout,)
            cin = cout
        shapes[f"box_head.conv5_{branch}.weight"] = (out, cin, 1, 1)
        shapes[f"box_head.conv5_{branch}.bias"] = (out,)
    return shapes


# -------------------------------------------------------------- network

def _keep(x):
    return x


def linear(x, w: dict, name: str, q=None):
    q = q or _keep
    return F.linear(q(x), q(w[name + ".weight"]), w[name + ".bias"])


def attention(x, w: dict, b: str, heads: int, q=None):
    """x (B, N, C) -> (the block's attention output (B, N, C), its
    probabilities (B, heads, N, N))."""
    bs, n, c = x.shape
    qkv = linear(x, w, b + "attn.qkv", q).reshape(bs, n, 3, heads,
                                                 c // heads)
    qq, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    attn = (qq @ k.transpose(-2, -1)) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(bs, n, c)
    return linear(out, w, b + "attn.proj", q), attn


def candidate_elimination(attn, tokens, lens_t: int, keep: float,
                          global_index, centre: int, theirs=None):
    """OSTrack's `candidate_elimination` with a one-token template mask:
    (tokens (B, lens_t + kept, C), the kept tokens' grid positions
    (B, kept), in the order kept, and the tokens of this ranking's top
    set outside `theirs` (B,)). theirs: None, or another's kept set over
    the current search tokens (B, L_s) bool, which is then kept instead
    (its tokens first, the rest in this ranking's order)."""
    lens_s = attn.shape[-1] - lens_t
    lens_keep = math.ceil(keep * lens_s)
    row = attn[:, :, centre, lens_t:].mean(dim=1)          # (B, L_s)
    _, order = torch.sort(row, dim=1, descending=True)
    top = order[:, :lens_keep]
    if theirs is None:
        swaps = torch.zeros(top.shape[0], dtype=torch.int64,
                            device=top.device)
    else:
        swaps = (~theirs.gather(1, top)).sum(dim=1)
        # a probability lies in [0, 1]: theirs first, then by the row
        _, order = torch.sort(theirs.double() * 2 + row.double(), dim=1,
                              descending=True)
        top = order[:, :lens_keep]
    kept = global_index.gather(1, top)
    tokens_s = tokens[:, lens_t:]
    c = tokens_s.shape[-1]
    attentive = tokens_s.gather(1, top.unsqueeze(-1).expand(-1, -1, c))
    return torch.cat([tokens[:, :lens_t], attentive], dim=1), kept, swaps


def embed(img, w: dict, which: str, s: dict):
    """Normalised images (B, 3, H, W) -> tokens (B, (H/16)^2, C) plus the
    position table of `which` ("z" template, "x" search)."""
    t = F.conv2d(img, w["backbone.patch_embed.proj.weight"],
                 w["backbone.patch_embed.proj.bias"], stride=s["patch"])
    return t.flatten(2).transpose(1, 2) + w[f"backbone.pos_embed_{which}"]


def backbone(z_tokens, x_tokens, w: dict, s: dict, q=None, follow=None):
    """Template and search tokens -> (the search map (B, C, F, F), the
    kept grid positions of each CE stage, sorted, and per stage the
    tokens of the reference's own top set that `follow` dropped (B,)).
    follow: None, or another's CE stages of each grid position (B, F*F)
    (`stages`), whose kept sets the blocks then keep."""
    lens_t, lens_x = z_tokens.shape[1], x_tokens.shape[1]
    x = torch.cat([z_tokens, x_tokens], dim=1)
    bs = x.shape[0]
    index = torch.arange(lens_x, device=x.device).repeat(bs, 1)
    centre, kept, swaps = centre_token(s), [], []
    d = s["dim"]
    for i in range(s["depth"]):
        b = f"backbone.blocks.{i}."
        out, attn = attention(
            F.layer_norm(x, (d,), w[b + "norm1.weight"],
                         w[b + "norm1.bias"], LN_EPS), w, b, s["heads"], q)
        x = x + out
        if i in s["ce_loc"]:
            theirs = None if follow is None else \
                follow.gather(1, index) > len(kept)
            x, index, n = candidate_elimination(attn, x, lens_t, s["keep"],
                                                index, centre, theirs)
            kept.append(index.sort(dim=1).values)
            swaps.append(n)
        h = F.layer_norm(x, (d,), w[b + "norm2.weight"], w[b + "norm2.bias"],
                         LN_EPS)
        h = F.gelu(linear(h, w, b + "mlp.fc1", q))
        x = x + linear(h, w, b + "mlp.fc2", q)
    x = F.layer_norm(x, (d,), w["backbone.norm.weight"],
                     w["backbone.norm.bias"], LN_EPS)
    full = torch.zeros((bs, lens_x, d), dtype=x.dtype, device=x.device)
    full.scatter_(1, index.unsqueeze(-1).expand(-1, -1, d), x[:, lens_t:])
    f = grid(s, s["search"])
    return full.transpose(1, 2).reshape(bs, d, f, f), kept, swaps


def stages(kept: list, bs: int, n: int, device=None) -> torch.Tensor:
    """Per-stage kept grid positions (B, kept) -> the CE stages that kept
    each of the n grid positions (B, n) uint8."""
    out = torch.zeros((bs, n), dtype=torch.uint8, device=device)
    for j, k in enumerate(kept):
        out.scatter_(1, k, j + 1)
    return out


def head(feat, w: dict, calibrate: bool = False):
    """The centre head on the search map (B, C, F, F) -> (score (B, 1, F,
    F), size (B, 2, F, F), offset (B, 2, F, F)). calibrate: each BN's
    running statistics are first set (in `w`, in place) to the biased
    statistics of what reaches it (the one-pass calibration of seeded
    weights)."""
    out = {}
    for branch, _ in BRANCHES:
        x = feat
        for k in range(1, 5):
            h = f"box_head.conv{k}_{branch}."
            x = F.conv2d(x, w[h + "0.weight"], w[h + "0.bias"], padding=1)
            if calibrate:
                w[h + "1.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
                w[h + "1.running_var"].copy_(x.var(dim=(0, 2, 3),
                                                   unbiased=False))
            x = F.relu(F.batch_norm(x, w[h + "1.running_mean"],
                                    w[h + "1.running_var"], w[h + "1.weight"],
                                    w[h + "1.bias"], False, 0.0, BN_EPS))
        out[branch] = F.conv2d(x, w[f"box_head.conv5_{branch}.weight"],
                               w[f"box_head.conv5_{branch}.bias"])

    def sigmoid(t):
        return torch.clamp(t.sigmoid(), min=1e-4, max=1 - 1e-4)
    return sigmoid(out["ctr"]), sigmoid(out["size"]), out["offset"]


def forward(z_img, x_img, w: dict, s: dict = SIZES, q=None,
            calibrate: bool = False) -> dict:
    """OSTrack's forward on normalised template and search images:
    {"score", "size", "offset", "kept" (a list per CE stage)}."""
    feat, kept, _ = backbone(embed(z_img, w, "z", s),
                             embed(x_img, w, "x", s), w, s, q)
    score, size, offset = head(feat, w, calibrate)
    return dict(score=score, size=size, offset=offset, kept=kept)


# ----------------------------------------------------------- the crop

def resize_u8(patch: np.ndarray, size: int) -> np.ndarray:
    """(n, n, 3) uint8 -> (size, size, 3) uint8, OpenCV's INTER_LINEAR
    as float32 arithmetic (module note)."""
    f32 = np.float32
    n = patch.shape[0]
    src = np.maximum(f32(n / size) * (np.arange(size, dtype=f32) + f32(0.5))
                     - f32(0.5), f32(0))
    i0 = np.minimum(src.astype(np.int64), n - 1)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = (src - i0).astype(f32)
    p = patch.astype(f32)
    fx = frac[None, :, None]
    fy = frac[:, None, None]
    top = (1 - fx) * p[i0][:, i0] + fx * p[i0][:, i1]
    bot = (1 - fx) * p[i1][:, i0] + fx * p[i1][:, i1]
    out = np.floor((1 - fy) * top + fy * bot + f32(0.5))
    return np.clip(out, 0, 255).astype(np.uint8)


def sample_target(im: np.ndarray, box, factor: float, out_sz: int):
    """OSTrack's `sample_target`: im (H, W, 3) uint8, box [x, y, w, h] ->
    (patch (out_sz, out_sz, 3) uint8, resize_factor out_sz / crop_sz)."""
    x, y, w, h = (float(v) for v in box)
    crop_sz = math.ceil(math.sqrt(w * h) * factor)
    x1 = round(x + 0.5 * w - crop_sz * 0.5)
    x2 = x1 + crop_sz
    y1 = round(y + 0.5 * h - crop_sz * 0.5)
    y2 = y1 + crop_sz
    x1_pad = max(0, -x1)
    x2_pad = max(x2 - im.shape[1] + 1, 0)
    y1_pad = max(0, -y1)
    y2_pad = max(y2 - im.shape[0] + 1, 0)
    crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad]
    padded = np.zeros((crop_sz, crop_sz, 3), np.uint8)
    padded[y1_pad:y1_pad + crop.shape[0], x1_pad:x1_pad + crop.shape[1]] = \
        crop
    return resize_u8(padded, out_sz), out_sz / crop_sz


def normalise(patches: np.ndarray, device) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (B, 3, S, S) float32, ImageNet's mean and
    std on [0, 1]."""
    t = torch.as_tensor(patches, device=device).permute(0, 3, 1, 2).float()
    mean = torch.tensor(MEAN, device=device)[None, :, None, None]
    std = torch.tensor(STD, device=device)[None, :, None, None]
    return (t / 255.0 - mean) / std


# ------------------------------------------------------------ tracker

def hann2d(n: int) -> torch.Tensor:
    """OSTrack's centred 2-D Hann window (n, n)."""
    h = 0.5 * (1 - torch.cos((2 * math.pi / (n + 1))
                             * torch.arange(1, n + 1).float()))
    return h[:, None] * h[None, :]


def clip_box(box, hh: float, ww: float, margin: int = MARGIN):
    """OSTrack's `clip_box` on arrays of [x, y, w, h] (..., 4)."""
    x1, y1, w, h = (box[..., i] for i in range(4))
    x2, y2 = x1 + w, y1 + h
    x1 = np.minimum(np.maximum(0, x1), ww - margin)
    x2 = np.minimum(np.maximum(margin, x2), ww)
    y1 = np.minimum(np.maximum(0, y1), hh - margin)
    y2 = np.minimum(np.maximum(margin, y2), hh)
    return np.stack([x1, y1, np.maximum(margin, x2 - x1),
                     np.maximum(margin, y2 - y1)], -1)


class Tracker:
    """OSTrack's tracker on the weights `w` at sizes `s`, on `device`."""

    def __init__(self, w: dict, s: dict = SIZES, q=None):
        self.w, self.s, self.q = w, s, q
        self.device = next(iter(w.values())).device
        self.window = hann2d(grid(s, s["search"])).to(self.device)

    def init(self, first: list, boxes) -> torch.Tensor:
        """Lanes' first frames and [x, y, w, h] boxes -> the template
        tokens (B, T, C)."""
        s = self.s
        z = np.stack([sample_target(im, b, s["template_factor"],
                                    s["template"])[0]
                      for im, b in zip(first, boxes)])
        return embed(normalise(z, self.device), self.w, "z", s)

    def candidates(self, frames: list, boxes: np.ndarray, z_tokens,
                   follow=None):
        """One step of each lane from its [x, y, w, h] box (float64 (B,
        4)) on its frame: every cell's outcome, float64 numpy: `box` (B,
        F*F, 4) the new box, `windowed` and `raw` (B, F*F) scores; the
        CE stages that kept each grid position, `stages` (B, F*F) uint8;
        and per CE stage the tokens of the reference's own top set that
        `follow` dropped, `swaps` (stages, B). follow: None, or a
        program's `stages` (B, F*F), whose kept sets are then kept."""
        s = self.s
        crops = [sample_target(im, b, s["search_factor"], s["search"])
                 for im, b in zip(frames, boxes)]
        x = normalise(np.stack([c[0] for c in crops]), self.device)
        if follow is not None:
            follow = torch.as_tensor(np.asarray(follow), device=self.device)
        feat, kept, swaps = backbone(z_tokens, embed(x, self.w, "x", s),
                                     self.w, s, self.q, follow)
        score, size, offset = head(feat, self.w)
        f = grid(s, s["search"])
        bs = score.shape[0]
        cells = torch.arange(f * f, device=self.device)
        cx = ((cells % f).float()[None] + offset[:, 0].flatten(1)) / f
        cy = ((cells // f).float()[None] + offset[:, 1].flatten(1)) / f
        pred = torch.stack([cx, cy, size[:, 0].flatten(1),
                            size[:, 1].flatten(1)], -1)        # (B, F*F, 4)
        rf = torch.tensor([c[1] for c in crops], dtype=torch.float32,
                          device=self.device)
        pred = (pred * s["search"] / rf[:, None, None]).double().cpu().numpy()
        half = (0.5 * s["search"] / np.array([c[1] for c in crops]))[:, None]
        cx_prev = (boxes[:, 0] + 0.5 * boxes[:, 2])[:, None]
        cy_prev = (boxes[:, 1] + 0.5 * boxes[:, 3])[:, None]
        cx = pred[..., 0] + (cx_prev - half)
        cy = pred[..., 1] + (cy_prev - half)
        new = np.stack([cx - 0.5 * pred[..., 2], cy - 0.5 * pred[..., 3],
                        pred[..., 2], pred[..., 3]], -1)
        hw = [im.shape[:2] for im in frames]
        new = np.stack([clip_box(new[i], *hw[i]) for i in range(bs)])
        return dict(box=new, cell_px=np.array([s["search"] / c[1] / f
                                               for c in crops]),
                    windowed=(score * self.window).flatten(1).double()
                    .cpu().numpy(),
                    raw=score.flatten(1).double().cpu().numpy(),
                    stages=stages(kept, bs, f * f, self.device).cpu().numpy(),
                    swaps=np.array([n.cpu().numpy() for n in swaps])
                    .reshape(len(swaps), bs))

    def track(self, frames, init_boxes, forced=None):
        """Lanes in lockstep. frames: per lane a (T + 1, H, W, 3) uint8
        numpy video (frame 0 the init frame); init_boxes: (B, 4) [x, y, w,
        h]; forced: None, or a program's (pos (B, T, 2) centres, sz (B, T,
        2), score (B, T), CE stages (B, T, F*F)) for frames 1..T. Returns
        (pos, sz, score, CE stages) as the lanes ran, and with `forced`
        the readings {"swaps", "gap", "box_px", "score", and "swaps<j>",
        stage j's swaps} (B, T)."""
        boxes = np.asarray(init_boxes, np.float64)
        names = ("pos", "sz", "score", "stages")
        with torch.no_grad():
            z = self.init([f[0] for f in frames], boxes)
            out = {k: [] for k in names}
            reads = {k: [] for k in ("swaps", "gap", "box_px", "score")}
            lanes = np.arange(len(frames))
            for t in range(1, len(frames[0])):
                cand = self.candidates(
                    [f[t] for f in frames], boxes, z,
                    None if forced is None else forced[3][:, t - 1])
                if forced is None:
                    k = cand["windowed"].argmax(axis=1)
                    new = cand["box"][lanes, k]
                    score = cand["raw"][lanes, k]
                    pos = new[:, :2] + 0.5 * new[:, 2:]
                    sz = new[:, 2:]
                else:
                    pos, sz = forced[0][:, t - 1], forced[1][:, t - 1]
                    score = forced[2][:, t - 1]
                    k, dist, miss = match(cand, pos, sz, score)
                    reads["swaps"].append(cand["swaps"].sum(axis=0))
                    for j, n in enumerate(cand["swaps"]):
                        reads.setdefault(f"swaps{j + 1}", []).append(n)
                    reads["gap"].append(cand["windowed"].max(1)
                                        - cand["windowed"][lanes, k])
                    reads["box_px"].append(dist[lanes, k])
                    reads["score"].append(miss[lanes, k])
                    new = np.concatenate([pos - 0.5 * sz, sz], -1)
                out["pos"].append(pos)
                out["sz"].append(sz)
                out["score"].append(score)
                out["stages"].append(cand["stages"] if forced is None
                                     else forced[3][:, t - 1])
                boxes = np.asarray(new, np.float64)
        result = tuple(np.stack(out[k], 1) for k in names)
        if forced is None:
            return result
        return result, {k: np.stack(v, 1) for k, v in reads.items()}


def match(cand: dict, pos, sz, score):
    """The cell each lane's program took, from its output box (pos, sz
    (B, 2)) and score (B,): of the cells whose box lies within a quarter
    of a cell's stride in frame pixels (`cell_px`) of the output's, the
    one with the best
    windowed score (where clipping makes cells' boxes coincide the box
    cannot tell them apart, and the program takes the best); where no
    cell's box lies so near, the cell whose box and score lie nearest.
    Returns (cells (B,), each cell's box distance in px (B, F*F), score
    distance (B, F*F))."""
    box = cand["box"]
    centre = box[..., :2] + 0.5 * box[..., 2:]
    dist = np.maximum(np.abs(centre - pos[:, None]).max(-1),
                      np.abs(box[..., 2:] - sz[:, None]).max(-1))
    miss = np.abs(cand["raw"] - score[:, None])
    near = (dist + 100.0 * miss).argmin(axis=1)
    same = dist <= 0.25 * cand["cell_px"][:, None]
    best = np.where(same, cand["windowed"], -np.inf).argmax(axis=1)
    return np.where(same.any(axis=1), best, near), dist, miss
