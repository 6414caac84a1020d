"""Pseudo-label mining's host half and the pieces around the flow network,
in plain NumPy, SciPy and PyTorch: copies of USOT's moving-object
discovery (github.com/VISION-SJTU/USOT `preprocessing/flow_module/
inference.py` and `flow_utils.py`, `datasets_train/*/par_crop.py`), not
imports of the program.

* `next_interval`: the adaptive loop's rule (interval in [1, 7]; shrink
  above 16 px of max|flow|, grow below 8; never back against the
  direction taken for this frame).
* `preprocess`: a BGR uint8 frame to the network's RGB input in [0, 1] at
  the test shape (cv2's INTER_LINEAR: half-pixel bilinear, no
  antialiasing); `to_frame`: a flow resized to the frame's size (bilinear,
  align_corners=True), each (dx, dy) scaled by the size ratio.
* `flow_to_bbox`: the margin-cut distance map of each vector from the mean
  vector, two thresholds (GROUPS), small objects and holes removed,
  8-connected regions scored by area, centre and the distance's peak,
  the best of each group kept.
* `smooth_bbox_dp`: the DP over candidate boxes with the modified-DIoU
  reward, the reversed interpolation between picks and the +-3 px
  perturbations of the frames before the first pick and after the last,
  drawn from the caller's `RandomState`; `calc_nearby_bbox_freq` and
  `calc_corner_bbox_freq`, the video's statistics.
* `crop_x`: the SiamFC instance crop of a frame at a box (its context
  square warped onto out x out, bilinear, the frame's per-channel mean
  outside), sampled by an explicit four-neighbour gather in float64.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

MAX_INTERVAL = 7
SHRINK_ABOVE, GROW_BELOW = 16, 8
GROUPS = ((0.7, 0.5), (0.84, 0.5))  # (mean_max_ratio, center_weight)
SALIENCY = 2.5
CUT_RATIO = 1 / 32
BBOX_REWARD = -0.091
_FOUR = ndimage.generate_binary_structure(2, 1)
_EIGHT = ndimage.generate_binary_structure(2, 2)


def next_interval(abs_max: float, adjacent: int, direction: int):
    """(interval, direction) of the next forward, or None to keep this
    flow (direction -1 shrinking, 1 growing, 0 neither yet)."""
    if abs_max > SHRINK_ABOVE and adjacent >= 2 and direction <= 0:
        return adjacent - 1, -1
    if abs_max < GROW_BELOW and adjacent <= MAX_INTERVAL - 1 \
            and direction >= 0:
        return adjacent + 1, 1
    return None


def preprocess(frame_bgr: np.ndarray, shape, device) -> torch.Tensor:
    """(1, 3, h, w) float32 RGB in [0, 1] at `shape` (h, w)."""
    x = torch.from_numpy(np.ascontiguousarray(frame_bgr[..., ::-1]))
    x = x.to(device).permute(2, 0, 1)[None].float()
    if tuple(x.shape[2:]) != tuple(shape):
        x = F.interpolate(x, size=tuple(shape), mode="bilinear",
                          align_corners=False, antialias=False)
    return x / 255.0


def to_frame(flow, h: int, w: int):
    """(B, 2, h', w') -> (B, 2, h, w), the vectors scaled by w / w' and
    h / h'."""
    fh, fw = flow.shape[2:]
    out = F.interpolate(flow, size=(h, w), mode="bilinear",
                        align_corners=True)
    return torch.stack([out[:, 0] * (w / fw), out[:, 1] * (h / fh)], 1)


def _remove_small_objects(mask, min_size):
    labels, n = ndimage.label(mask, structure=_FOUR)
    if n == 0:
        return mask
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    keep = np.zeros(n + 1, bool)
    keep[1:] = sizes >= min_size
    return keep[labels]


def _remove_small_holes(mask, max_size):
    labels, n = ndimage.label(~mask, structure=_FOUR)
    if n == 0:
        return mask
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    fill = np.zeros(n + 1, bool)
    fill[1:] = sizes < max_size
    return mask | fill[labels]


def _regions(mask):
    """8-connected regions' (min_row, min_col, max_row, max_col), max
    exclusive (skimage's `regionprops(...).bbox`)."""
    labels, _ = ndimage.label(mask, structure=_EIGHT)
    return [(s[0].start, s[1].start, s[0].stop, s[1].stop)
            for s in ndimage.find_objects(labels) if s is not None]


def _best_boxes(distance, mean_d, max_d, center_weight, mean_max_ratio,
                top_n=1, small_ratio=0.02, border_ratio=0.7):
    h_c, w_c = distance.shape
    peak = np.unravel_index(np.argmax(distance), distance.shape)
    boxes, scores = [], []
    if not (mean_d < 0.05 or max_d / mean_d > SALIENCY):
        return boxes
    mask = distance >= mean_max_ratio * mean_d + (1 - mean_max_ratio) * max_d
    mask = _remove_small_holes(_remove_small_objects(mask, 80), 80)
    for r0, c0, r1, c1 in _regions(mask):
        if r1 - r0 < h_c * small_ratio or c1 - c0 < w_c * small_ratio:
            continue
        area = (r1 - r0) * (c1 - c0)
        if area < 50:
            continue
        score = center_weight * min(h_c - r1, r0) * min(w_c - c1, c0) + area
        if r0 <= peak[0] <= r1 and c0 <= peak[1] <= c1:
            score *= 2
        if min(h_c - r1, r0) <= 15:
            score /= 2
            if c1 - c0 > w_c * border_ratio:
                continue
        if min(w_c - c1, c0) <= 15:
            score /= 2
            if r1 - r0 > h_c * border_ratio:
                continue
        if r1 == r0 or (c1 - c0) / (r1 - r0) > 6:
            continue
        if c1 == c0 or (r1 - r0) / (c1 - c0) > 6:
            continue
        at = len(boxes)
        for k in range(len(boxes) - 1, -1, -1):
            if score > scores[k]:
                at = k
            else:
                break
        if at < top_n:
            boxes.insert(at, (c0, r0, c1, r1))
            scores.insert(at, score)
        boxes, scores = boxes[:top_n], scores[:top_n]
    return boxes


def flow_to_bbox(flow: np.ndarray) -> list:
    """flow (H, W, 2) -> candidate boxes (x1, y1, x2, y2), one per group
    at most."""
    h, w, _ = flow.shape
    cut = CUT_RATIO
    clip = flow[int(h * cut):int(h * (1 - cut)),
                int(w * cut):int(w * (1 - cut))]
    mean_vec = np.mean(clip, axis=(0, 1))
    distance = np.sqrt(np.sum((clip - mean_vec) ** 2, axis=2))
    mean_d, max_d = distance.mean(), distance.max()
    out = []
    for ratio, cw in GROUPS:
        out.extend(_best_boxes(distance, mean_d, max_d, cw, ratio))
    return [(b[0] + cut * w, b[1] + cut * h, b[2] + cut * w, b[3] + cut * h)
            for b in out]


def diou_modify(b1, b2):
    """DIoU with the centre-distance penalty x4.1, negatives tripled."""
    b1, b2 = np.asarray(b1, np.float64), np.asarray(b2, np.float64)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    inter = np.clip(np.minimum(b1[2:], b2[2:]) - np.maximum(b1[:2], b2[:2]),
                    0, 5000)
    inter_area = inter[0] * inter[1]
    centre = ((b2[2] + b2[0]) / 2 - (b1[2] + b1[0]) / 2) ** 2 \
        + ((b2[3] + b2[1]) / 2 - (b1[3] + b1[1]) / 2) ** 2
    outer = np.clip(np.maximum(b1[2:], b2[2:]) - np.minimum(b1[:2], b2[:2]),
                    0, 5000)
    d = inter_area / (a1 + a2 - inter_area) \
        - centre / (outer[0] ** 2 + outer[1] ** 2) * 4.1
    return d * 3 if d < 0 else d


def smooth_bbox_dp(bboxes, length, rng, gap=3, max_dp_gap=100):
    """(boxes of every frame, picked frames, found share, picked share,
    mean variation); `bboxes`: candidates of each sampled frame."""
    cands = []
    for k, frame in enumerate(range(gap, length - gap, gap)):
        if bboxes[k]:
            cands.append((bboxes[k], frame))
    if not cands:
        raise ValueError("no candidate boxes in video")
    reward = BBOX_REWARD
    cost = [[reward] * len(cands[0][0])]
    back = [[(-1, -1)] * len(cands[0][0])]
    for n in range(1, len(cands)):
        row, rows_back = [], []
        for box in cands[n][0]:
            best, arg = reward, (-1, -1)
            for m in range(max(0, n - max_dp_gap), n):
                for s, prev in enumerate(cands[m][0]):
                    c = cost[m][s] - diou_modify(box, prev) + reward
                    if c <= best:
                        best, arg = c, (m, s)
            row.append(best)
            rows_back.append(arg)
        cost.append(row)
        back.append(rows_back)
    last, best = (len(cands) - 1, 0), cost[-1][0]
    for n in range(len(cands) - 1, -1, -1):
        for s in range(len(cands[n][0])):
            if cost[n][s] <= best:
                last, best = (n, s), cost[n][s]
    picked = []
    while last[1] != -1:
        picked.insert(0, (cands[last[0]][0][last[1]], cands[last[0]][1]))
        last = back[last[0]][last[1]]

    out, done, frames = [], -1, []
    for p, (box, frame) in enumerate(picked):
        frames.append(frame)
        for j in range(done + 1, frame):
            if p == 0:
                if min(box) < 75:
                    out.append(box)
                else:
                    d = rng.uniform(-3, 3, size=4)
                    out.append(tuple(box[k] + d[k] for k in range(4)))
            else:
                prev = picked[p - 1][0]
                r = (j - done) / (frame - done)  # the reversed interpolation
                out.append(tuple(prev[k] * r + box[k] * (1 - r)
                                 for k in range(4)))
        out.append(box)
        done = frame
    last_box = out[-1]
    for _ in range(length - len(out)):
        if min(last_box) < 50:
            out.append(last_box)
        else:
            d = rng.uniform(-3, 3, size=4)
            out.append(tuple(last_box[k] + d[k] for k in range(4)))
    vary = sum(abs(out[i][k] - out[i + 1][k]) for i in range(length - 1)
               for k in range(4)) / (length - 1)
    return (out, frames, len(cands) / len(bboxes), len(picked) / len(bboxes),
            vary)


def calc_nearby_bbox_freq(picked, video_length, search_range=(3, 10), gap=3):
    ranges = [s * gap for s in search_range]
    freq = np.zeros((len(ranges), video_length))
    most = np.zeros((len(ranges), video_length))
    for r, sr in enumerate(ranges):
        for v in range(gap, video_length - gap, gap):
            most[r, max(0, v - sr):min(video_length - 1, v + sr) + 1] += 1
        for v in picked:
            freq[r, max(0, v - sr):min(video_length - 1, v + sr) + 1] += 1
    return [[float(freq[r, v] / most[r, v]) if most[r, v] else 0.0
             for r in range(len(ranges))] for v in range(video_length)]


def calc_corner_bbox_freq(boxes, img_shape):
    h, w = img_shape
    cut = CUT_RATIO
    ax = [int(cut * w), int(cut * h), int((1 - cut) * w), int((1 - cut) * h)]
    corner = 0.0
    for x1, y1, x2, y2 in boxes:
        xc = x1 < ax[0] + 10 or x2 > ax[2] - 10
        yc = y1 < ax[1] + 10 or y2 > ax[3] - 10
        corner += 1.0 if xc and yc else 0.3 if xc or yc else 0.0
    return corner / len(boxes)


def crop_x(frame: torch.Tensor, box, out: int = 511, exemplar: int = 127,
           context_amount: float = 0.5) -> torch.Tensor:
    """The instance crop (out, out, 3) uint8 of `frame` (H, W, 3) uint8 on
    any device at `box` (x1, y1, x2, y2): the context square s_z =
    sqrt((h + p) (w + p)), p = (w + h) / 2, with w and h swapped as
    USOT's `par_crop.py` has them, widened to s_x = s_z * out / exemplar,
    mapped onto out x out pixels corner to corner; the frame's
    per-channel mean (rounded to even) outside."""
    x1, y1, x2, y2 = (float(v) for v in box)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    tw, th = x2 - x1, y2 - y1
    p = context_amount * (tw + th)
    s_z = np.sqrt((th + p) * (tw + p))
    s_x = s_z + 2 * ((out - exemplar) / 2) / (exemplar / s_z)
    a = (out - 1) / s_x
    dev = frame.device
    img = frame.to(torch.float64)
    h, w = img.shape[:2]
    fill = torch.round(img.mean((0, 1)))  # round half to even, as cv2
    t = torch.arange(out, dtype=torch.float64, device=dev) / a
    sx, sy = t + (cx - s_x / 2), t + (cy - s_x / 2)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[None, :, None], (sy - y0)[:, None, None]
    x0, y0 = x0.long(), y0.long()

    def tap(ys, xs):
        inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None]
        v = img[ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1)]
        return torch.where(inside[..., None], v, fill)
    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    val = top * (1 - fy) + bot * fy
    return torch.round(val).clamp(0, 255).to(torch.uint8)


def replay(weights: dict, frames: list, decisions: list, cfg: dict,
           rng_seed, device) -> dict:
    """The reference's reading of one mined video: for each of the
    program's forwards `decisions` [(frame i, interval, max|flow|)], its
    own flow of the triple (max(0, i - interval), i, min(i + interval,
    n - 1)) from the uint8 `frames` (BGR, host) and that flow's max|flow|
    at the frame's size; from the last forward of each sampled frame
    (the flow the loop kept) its candidate boxes, and from those its DP
    (`RandomState(rng_seed)`) with the video's statistics. Returns
    {"maxflow": [per forward], "sampled": frames whose flow was kept,
    "mined": (boxes, picked, found, picked share, vary, nearby freqs,
    corner share) or None where no frame has a candidate}."""
    from portbench.reference.numerics import deterministic
    from portbench.reference.pwclite import flows_3_frames

    shape, gap = tuple(cfg["test_shape"]), cfg["mining"]["gap"]
    n, (h, w) = len(frames), frames[0].shape[:2]
    pre, maxflow, cands, sampled = {}, [], [], []

    def net_input(j):
        if j not in pre:
            pre[j] = preprocess(frames[j], shape, device)
        return pre[j]
    with deterministic(), torch.no_grad():
        for k, (i, interval, _) in enumerate(decisions):
            lo, hi = max(0, i - interval), min(i + interval, n - 1)
            f12, _ = flows_3_frames(weights, net_input(lo), net_input(i),
                                    net_input(hi))
            flow = to_frame(f12, h, w)
            maxflow.append(float(flow.abs().amax()))
            if k + 1 == len(decisions) or decisions[k + 1][0] != i:
                sampled.append(i)
                cands.append(flow_to_bbox(flow[0].permute(1, 2, 0).cpu()
                                          .numpy()))
    mined = None
    if sampled == list(range(gap, n - gap, gap)):
        try:
            dp = smooth_bbox_dp(cands, n, np.random.RandomState(rng_seed),
                                gap)
        except ValueError:
            dp = None
        if dp is not None:
            mined = (*dp, calc_nearby_bbox_freq(dp[1], len(dp[0]), gap=gap),
                     calc_corner_bbox_freq(dp[0], (h, w)))
    return {"maxflow": maxflow, "sampled": sampled, "mined": mined}
