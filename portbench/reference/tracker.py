"""The USOT* tracker around `net.Net`, in plain PyTorch and NumPy, written
from the published description (arXiv 2108.12711; the reference's
`experiments/test` settings): crops, the template and memory bootstrap
at init, the response postprocess, and the memory queue.

Two crops, as the two tracking paths of the measured program take them:
* `host_crop`: the integer window [round(p - (s + 1) / 2), + s - 1],
  padded with the frame's channel means (stored as uint8), resized to the
  model size by half-pixel-centre bilinear with edge clamp and rounded
  to uint8 (OpenCV's INTER_LINEAR). Init always crops so; the B=1
  tracker crops every frame so.
* `gather_crop`: the same window sampled in float bilinear straight from
  the frame, taps outside the frame reading the channel means (the batch
  engine's on-device crop).

`track` runs lanes of one size in lockstep. Free-running it picks each
frame's best cell itself (the lower-precision control takes the
program's place so). Given a program's outputs (`forced`) it follows
them instead: each frame is cropped at the program's previous box, the
program's chosen cell is found from its output (`match`), and the
frame's memory entry is that cell's pooled feature with the program's
score as its confidence. Per frame it then
reads three numbers: `gap`, how far the chosen cell's penalised score
lies below the best; `box_px`, the largest difference in px between
the program's box (centre, size) and the cell's; `score`, the
difference between the program's score and the cell's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.net import Net, prpool


def feature_axis(n: int, stride: int, size: int) -> np.ndarray:
    return (np.arange(n) - n // 2) * float(stride) + size // 2


def box_to_cells(box, axis, n: int, clip_cells: float):
    """Image-axis [x1, y1, x2, y2] -> cell coordinates on a feature axis,
    clipped `clip_cells` cells past its ends."""
    lo, hi = float(axis[0]), float(axis[-1])
    slope = 2 * (n // 2) / (hi - lo)
    b = np.clip(np.asarray(box, np.float64), lo - clip_cells / slope,
                hi + clip_cells / slope)
    return (b - lo) * slope


def round_half_away(f: float) -> float:
    """Python 2's round (the reference's search-size rounding)."""
    return math.floor(abs(f) + 0.5) * (1 if f >= 0 else -1)


def resize_u8(patch: np.ndarray, size: int) -> np.ndarray:
    """(h, w, 3) uint8 -> (size, size, 3) uint8: src = (dst + 0.5) * h /
    size - 0.5 clamped at 0, two taps, the far one clamped to the edge,
    in float32, rounded half up."""
    f32 = np.float32

    def taps(n):
        src = np.maximum(f32(n / size) * (np.arange(size, dtype=f32)
                                          + f32(0.5)) - f32(0.5), f32(0))
        i0 = np.minimum(src.astype(np.int64), n - 1)
        i1 = np.minimum(i0 + 1, n - 1)
        return i0, i1, (src - i0).astype(f32)
    y0, y1, fy = taps(patch.shape[0])
    x0, x1, fx = taps(patch.shape[1])
    p = patch.astype(f32)
    fx = fx[None, :, None]
    fy = fy[:, None, None]
    top = (1 - fx) * p[y0][:, x0] + fx * p[y0][:, x1]
    bot = (1 - fx) * p[y1][:, x0] + fx * p[y1][:, x1]
    out = np.floor((1 - fy) * top + fy * bot + f32(0.5))
    return np.clip(out, 0, 255).astype(np.uint8)


def host_crop(im: np.ndarray, pos, size: float, avg, model_sz: int,
              target_sz=None):
    """The host crop (module note) -> (patch (m, m, 3) uint8, the target's
    box in patch pixels or None)."""
    h, w = im.shape[:2]
    size = int(size)
    x0 = int(round(pos[0] - (size + 1) / 2))
    y0 = int(round(pos[1] - (size + 1) / 2))
    left, top = max(0, -x0), max(0, -y0)
    right, bottom = max(0, x0 + size - w), max(0, y0 + size - h)
    if left or top or right or bottom:
        canvas = np.empty((h + top + bottom, w + left + right, 3), np.uint8)
        canvas[...] = np.asarray(avg).astype(np.uint8)
        canvas[top:top + h, left:left + w] = im
    else:
        canvas = im
    patch = canvas[y0 + top:y0 + top + size, x0 + left:x0 + left + size]
    out = resize_u8(patch, model_sz) if size != model_sz else patch
    if target_sz is None:
        return out, None
    tx0 = round(pos[0] - target_sz[0] / 2)
    tx1 = round(pos[0] + target_sz[0] / 2)
    ty0 = round(pos[1] - target_sz[1] / 2)
    ty1 = round(pos[1] + target_sz[1] / 2)
    slope = size / (size - 1)
    k = model_sz / size
    box = [k * (left - 1 + slope * (tx0 - x0 - left)),
           k * (top - 1 + slope * (ty0 - y0 - top)),
           k * (left - 1 + slope * (tx1 - x0 - left)),
           k * (top - 1 + slope * (ty1 - y0 - top))]
    return out, box


def gather_crop(frames, pos, s_x, avg, model_sz: int):
    """The float crop (module note): frames (N, H, W, 3) uint8 tensor, pos
    (N, 2), s_x (N,) window sizes, avg (N, 3), all float32 tensors on the
    frames' device -> (N, m, m, 3) float32."""
    n, h, w, _ = frames.shape
    size = torch.round(s_x)
    corner = torch.round(pos - ((s_x + 1.0) / 2.0)[:, None])       # (N, 2)
    d = (torch.arange(model_sz, dtype=torch.float32, device=frames.device)
         + 0.5)[None] * (size / model_sz)[:, None] - 0.5           # (N, m)
    sx, sy = corner[:, 0:1] + d, corner[:, 1:2] + d
    avg = avg.float()

    def axis(src, limit):
        i0 = torch.floor(src)
        return i0.long(), src - i0, limit

    x0, fx, _ = axis(sx, w)
    y0, fy, _ = axis(sy, h)
    lanes = torch.arange(n, device=frames.device)[:, None, None]
    out = 0.0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy = (y0 + dy)[:, :, None].expand(n, model_sz, model_sz)
            xx = (x0 + dx)[:, None, :].expand(n, model_sz, model_sz)
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            pix = frames[lanes, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            pix = torch.where(inside[..., None], pix.float(),
                              avg[:, None, None, :])
            out = out + pix * (wy[:, :, None, None] * wx[:, None, :, None])
    return out


class Tracker:
    """The tracker's constants (`cfg`: the configuration's `tracker`
    block) and its steps, on a `Net`."""

    def __init__(self, net: Net, cfg: dict):
        self.net = net
        self.c = dict(cfg)
        c = self.c
        self.s = (c["instance_size"] - c["exemplar_size"]) \
            // c["total_stride"] + 1 + 8
        n = self.s
        g = (np.arange(n) - n // 2) * float(c["total_stride"]) \
            + c["instance_size"] // 2
        self.gx, self.gy = np.meshgrid(g, g)
        han = np.hanning(n)
        self.window = np.outer(han, han)
        self.tf_axis = feature_axis(c["tf_size"], c["total_stride"],
                                    c["exemplar_size"])
        self.sf_axis = feature_axis(c["sf_size"], c["total_stride"],
                                    c["instance_size"])

    # -- init --

    def init_crops(self, im: np.ndarray, pos, sz):
        """Host crops of one video's first frame: the template, its box on
        the template feature axis, the search crop and its left-right
        flip with their boxes on the search feature axis, the mean."""
        c = self.c
        pos = np.asarray(pos, np.float64)
        sz = np.asarray(sz, np.float64)
        avg = np.mean(im, axis=(0, 1))
        ctx = c["context_amount"] * sz.sum()
        s_z_f = math.sqrt((sz[0] + ctx) * (sz[1] + ctx))
        z, zbox = host_crop(im, pos, round(s_z_f), avg, c["exemplar_size"],
                            sz)
        tb = box_to_cells(zbox, self.tf_axis, c["tf_size"], 0.0)
        s_x = self._search_span(s_z_f)
        x, xbox = host_crop(im, pos, round_half_away(s_x), avg,
                            c["instance_size"], sz)
        m = x.shape[1]
        flip = [min(max(v, 0.0), m) for v in
                (m - xbox[2], xbox[1], m - xbox[0], xbox[3])]
        return dict(z=z, tb=tb, x=x, x_flip=x[:, ::-1].copy(),
                    sb=box_to_cells(xbox, self.sf_axis, c["sf_size"], 1.0),
                    sb_flip=box_to_cells(flip, self.sf_axis, c["sf_size"],
                                         1.0), avg=avg)

    def init(self, crops: list, device):
        """Lanes' init crops -> (template encodings (cls, reg), the two
        encoded memory anchors per lane: 3 x (N, 2, C, h, w), the first
        memory entry per lane: 3 x (N, C, h, w))."""
        net = self.net

        def t(key):
            return torch.as_tensor(np.stack([c[key] for c in crops]),
                                   dtype=torch.float32, device=device)
        zf = net.template(t("z"), t("tb"))
        n = len(crops)
        xs = torch.cat([t("x"), t("x_flip")])
        boxes = torch.cat([t("sb"), t("sb_flip")])
        feats = prpool(net.features(xs), boxes)
        enc = net.encode(feats, "cls", "k")
        anchors = [torch.stack([e[:n], e[n:]], dim=1) for e in enc]
        return ((net.encode(zf, "cls", "k"), net.encode(zf, "reg", "k")),
                anchors, [e[:n] for e in enc])

    # -- one frame --

    def search_size(self, sz):
        """(N, 2) float32 sizes -> (scale_z (N,), s_x (N,)) in float32,
        the program's own arithmetic on its float32 state."""
        c = self.c
        ctx = c["context_amount"] * (sz[:, 0] + sz[:, 1])
        s_z = torch.sqrt((sz[:, 0] + ctx) * (sz[:, 1] + ctx))
        scale_z = c["exemplar_size"] / s_z
        d = (c["instance_size"] - c["exemplar_size"]) / 2
        return scale_z, torch.round(s_z + 2 * d / scale_z)

    def heads(self, crops, zenc, queue):
        """Crops (N, m, m, 3) -> (cls, bbox (N, 4, S, S), cls_mem, the
        search features); queue: 3 x (N * Q, C, h, w)."""
        net = self.net
        xf = net.features(crops)
        cls_x = net.encode(xf, "cls", "s")
        bbox, cls = net.offline(zenc[0], zenc[1], cls_x,
                                net.encode(xf, "reg", "s"))
        cls_mem = net.memory(cls_x, queue, self.c["mem_queue_size"])
        return cls[:, 0], bbox, cls_mem[:, 0], xf

    def candidates(self, cls, bbox, cls_mem, pos, sz, scale_z, im_hw):
        """Every cell's outcome, float64 numpy: pscore (N, S*S), score,
        the new centre and size (N, S*S, 2) clamped to the image, and the
        cell's box in crop pixels (N, S*S, 4)."""
        c = self.c
        f = [t.double().cpu().numpy() for t in (cls, bbox, cls_mem)]
        cls, bbox, cls_mem = f
        pos = np.asarray(pos, np.float64)
        sz = np.asarray(sz, np.float64)
        sc = np.asarray(scale_z, np.float64)[:, None, None]
        score = c["ratio"] / (1 + np.exp(-cls)) \
            + (1 - c["ratio"]) / (1 + np.exp(-cls_mem))
        x1, y1 = self.gx - bbox[:, 0], self.gy - bbox[:, 1]
        x2, y2 = self.gx + bbox[:, 2], self.gy + bbox[:, 3]
        w = (sz[:, 0] * sc[:, 0, 0])[:, None, None]
        h = (sz[:, 1] * sc[:, 0, 0])[:, None, None]

        def size(a, b):
            pad = (a + b) / 2
            return np.sqrt((a + pad) * (b + pad))

        def change(r):
            return np.maximum(r, 1 / r)

        with np.errstate(all="ignore"):
            s_c = change(size(x2 - x1, y2 - y1) / size(w, h))
            r_c = change((w / h) / ((x2 - x1) / (y2 - y1)))
            penalty = np.exp(-(r_c * s_c - 1) * c["penalty_k"])
            pscore = penalty * score * (1 - c["window_influence"]) \
                + self.window * c["window_influence"]
        pscore = np.where(np.isnan(pscore), -np.inf, pscore)
        lr = penalty * score * c["lr"]
        half = c["instance_size"] // 2
        cx = pos[:, 0, None, None] + ((x1 + x2) / 2 - half) / sc
        cy = pos[:, 1, None, None] + ((y1 + y2) / 2 - half) / sc
        tw = sz[:, 0, None, None]
        th = sz[:, 1, None, None]
        nw = tw * (1 - lr) + lr * ((x2 - x1) / sc * lr + (1 - lr) * tw)
        nh = th * (1 - lr) + lr * ((y2 - y1) / sc * lr + (1 - lr) * th)
        hh, ww = im_hw
        n = cls.shape[0]
        centre = np.stack([np.clip(cx, 0, ww), np.clip(cy, 0, hh)], -1)
        dims = np.stack([np.minimum(np.maximum(nw, 10), ww),
                         np.minimum(np.maximum(nh, 10), hh)], -1)
        return dict(pscore=pscore.reshape(n, -1), score=score.reshape(n, -1),
                    pos=centre.reshape(n, -1, 2), sz=dims.reshape(n, -1, 2),
                    box=np.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4))

    def pool_box(self, crop_box):
        """Chosen cells' crop-pixel boxes (N, 4) -> cells of the search
        feature map, clipped one cell past the axis."""
        return box_to_cells(crop_box, self.sf_axis, self.c["sf_size"], 1.0)

    # -- the memory queue --

    def picks(self, conf: list) -> list:
        """Memory entries the queue reads after the two anchors: the best
        of n_queue - 3 segments of the history, then the newest (the
        reference's segment bounds, its index arithmetic included)."""
        n_update = self.c["mem_queue_size"] - 3
        length = len(conf)
        if length <= 1:
            return [0] * (n_update + 1)
        gap = (length - 1) / n_update
        out = []
        for i in range(n_update):
            start = min(int(int(i * gap) * length), length - 1)
            end = min(int(int((i + 1) * gap) * length), length - 1)
            out.append(start if start >= end
                       else start + int(np.argmax(conf[start:end])))
        return out + [length - 1]

    # -- a run --

    def track(self, frames, init, forced=None, crop="gather"):
        """Lanes tracked in lockstep over their frames.

        frames: per lane, (T + 1, H, W, 3) uint8 (frame 0 the init frame),
        one size for all lanes; a stacked tensor with `crop="gather"`,
        numpy with `crop="host"`. init: per lane (pos, sz). forced: None,
        or (pos (N, T, 2), sz (N, T, 2), score (N, T)) numpy, a program's
        outputs for frames 1..T.
        Returns (pos, sz, score) as the lanes ran, and with `forced` the
        per-frame readings {"gap", "box_px", "score"} (N, T)."""
        if crop == "gather":
            device = frames.device
            hw = tuple(frames.shape[2:4])
            first = [frames[i, 0].cpu().numpy() for i in range(len(init))]
        else:
            device = self.net.w[next(iter(self.net.w))].device
            hw = frames[0].shape[1:3]
            first = [f[0] for f in frames]
        n, steps = len(init), (frames.shape[1] if crop == "gather"
                               else len(frames[0])) - 1
        crops = [self.init_crops(im, p, s) for im, (p, s) in zip(first, init)]
        zenc, anchors, mem0 = self.init(crops, device)
        mem = [[[e[i]] for e in mem0] for i in range(n)]  # lane, scale, k
        conf = [[0.9] for _ in range(n)]
        avg = torch.as_tensor(np.stack([c["avg"] for c in crops]),
                              dtype=torch.float32, device=device)
        pos = torch.as_tensor(np.stack([p for p, _ in init]),
                              dtype=torch.float32)
        sz = torch.as_tensor(np.stack([s for _, s in init]),
                             dtype=torch.float32)
        pos_np = np.stack([p for p, _ in init]).astype(np.float64)
        sz_np = np.stack([s for _, s in init]).astype(np.float64)
        out = {k: [] for k in ("pos", "sz", "score")}
        reads = {k: [] for k in ("gap", "box_px", "score")}
        for t in range(1, steps + 1):
            if crop == "gather":
                scale_z, s_x = self.search_size(sz)
                x = gather_crop(frames[:, t], pos.to(device),
                                s_x.to(device), avg, self.c["instance_size"])
            else:
                scale_z, x = self._host_search(frames, t, pos_np, sz_np,
                                               crops, device)
            queue = []
            for s in range(3):
                rows = [torch.cat([anchors[s][i],
                                   torch.stack([mem[i][s][k] for k in
                                                self.picks(conf[i])])])
                        for i in range(n)]
                queue.append(torch.cat(rows))
            cls, bbox, cls_mem, xf = self.heads(x, zenc, queue)
            base_pos = pos_np if crop == "host" else pos.double().numpy()
            base_sz = sz_np if crop == "host" else sz.double().numpy()
            cand = self.candidates(cls, bbox, cls_mem, base_pos, base_sz,
                                   np.asarray(scale_z, np.float64), hw)
            if forced is None:
                k = cand["pscore"].argmax(axis=1)
                lanes = np.arange(n)
                new_pos, new_sz = cand["pos"][lanes, k], cand["sz"][lanes, k]
                score = cand["score"][lanes, k]
            else:
                new_pos, new_sz = forced[0][:, t - 1], forced[1][:, t - 1]
                score = forced[2][:, t - 1]
                k, dist, miss = self.match(cand, new_pos, new_sz, score,
                                           np.asarray(scale_z, np.float64))
                lanes = np.arange(n)
                reads["gap"].append(cand["pscore"].max(1)
                                    - cand["pscore"][lanes, k])
                reads["box_px"].append(dist[lanes, k])
                reads["score"].append(miss[lanes, k])
            boxes = torch.as_tensor(self.pool_box(cand["box"][np.arange(n),
                                                              k]),
                                    dtype=torch.float32, device=device)
            enc = self.net.encode(prpool(xf, boxes), "cls", "k")
            for i in range(n):
                for s in range(3):
                    mem[i][s].append(enc[s][i])
                conf[i].append(float(score[i]))
            out["pos"].append(new_pos)
            out["sz"].append(new_sz)
            out["score"].append(score)
            pos_np = np.asarray(new_pos, np.float64)
            sz_np = np.asarray(new_sz, np.float64)
            pos = torch.as_tensor(pos_np, dtype=torch.float32)
            sz = torch.as_tensor(sz_np, dtype=torch.float32)
        result = tuple(np.stack(out[k], 1) for k in ("pos", "sz", "score"))
        if forced is None:
            return result
        return result, {k: np.stack(v, 1) for k, v in reads.items()}

    def match(self, cand, pos, sz, score, scale_z):
        """The cell each lane's program took, from its output box (pos,
        sz (N, 2)) and score (N,): of the cells whose box lies within a
        quarter of a cell's stride (in image pixels, at the lane's scale)
        of the output's, the one with the best penalised score, since
        where cells' boxes coincide (a size at its 10-px floor, a centre
        clamped to the image's edge) the box cannot tell them apart and
        the program takes the best; where no cell's box lies so near,
        the cell whose box and score lie nearest. Returns (cells (N,),
        each cell's box distance in px (N, S*S), score distance (N,
        S*S))."""
        dist = np.maximum(np.abs(cand["pos"] - pos[:, None]).max(-1),
                          np.abs(cand["sz"] - sz[:, None]).max(-1))
        miss = np.abs(cand["score"] - score[:, None])
        near = (dist + 100.0 * miss).argmin(axis=1)
        same = dist <= 0.25 * self.c["total_stride"] / scale_z[:, None]
        best = np.where(same, cand["pscore"], -np.inf).argmax(axis=1)
        return np.where(same.any(axis=1), best, near), dist, miss

    def _search_span(self, s_z: float) -> float:
        """The search window's span in float64, in the reference's order:
        s_z + 2 * ((instance - exemplar) / 2) / (exemplar / s_z)."""
        c = self.c
        pad = (c["instance_size"] - c["exemplar_size"]) / 2 \
            / (c["exemplar_size"] / s_z)
        return s_z + 2 * pad

    def _host_search(self, frames, t, pos, sz, crops, device):
        """The B=1 tracker's search crops of frame t, in float64 from its
        float64 state."""
        c = self.c
        scale_z, xs = [], []
        for i in range(len(frames)):
            ctx = c["context_amount"] * sz[i].sum()
            s_z = math.sqrt((sz[i][0] + ctx) * (sz[i][1] + ctx))
            s_x = self._search_span(s_z)
            x, _ = host_crop(frames[i][t], pos[i], round_half_away(s_x),
                             crops[i]["avg"], c["instance_size"])
            scale_z.append(c["exemplar_size"] / s_z)
            xs.append(x)
        return np.asarray(scale_z), torch.as_tensor(
            np.stack(xs), dtype=torch.float32, device=device)
