"""SiamFC-style crop511 generation + train.json assembly: the port's own
copy of `usot_tpu/preprocessing/crop_gen.py`
(ref: preprocessing/datasets_train/*/par_crop.py, gen_json.py).

`crop_like_siamfc` produces the 511 'x' (and 127 'z') crops the training
loader consumes ({frame:06d}.{track:02d}.x.jpg naming); `build_train_json`
turns mined box sequences + quality stats into the loader's annotation
schema, including the two-pointer [T_l, T_u] memory-fragment scan. The
warps are `data/cvops.warp_affine` (cv2's within one grey level), frames
are read and crops written through `data/imageio` or the caller's
`reader` / `writer`.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join

import numpy as np

from usot_tpu_torch.data import imageio
from usot_tpu_torch.data.cvops import warp_affine
from usot_tpu_torch.preprocessing.flow2box import diou_modify


def crop_hwc(image, bbox, out_sz, padding=(0, 0, 0)):
    """`cv2.warpAffine` of the box onto an out_sz square, BORDER_CONSTANT
    with `padding` (per channel)."""
    a = (out_sz - 1) / (bbox[2] - bbox[0])
    b = (out_sz - 1) / (bbox[3] - bbox[1])
    c = -a * bbox[0]
    d = -b * bbox[1]
    mapping = np.array([[a, 0, c], [0, b, d]], np.float64)
    return warp_affine(image, mapping, (out_sz, out_sz),
                       border_value=padding)


def pos_s_2_bbox(pos, s):
    return [pos[0] - s / 2, pos[1] - s / 2, pos[0] + s / 2, pos[1] + s / 2]


def crop_like_siamfc(image, bbox, context_amount=0.5, exemplar_size=127,
                     instance_size=255, padding=(0, 0, 0)):
    """Returns (z 127-crop, x instance_size-crop). Note the reference swaps
    w/h when computing wc/hc (ref: par_crop.py:64-67) — kept for parity."""
    target_pos = [(bbox[2] + bbox[0]) / 2.0, (bbox[3] + bbox[1]) / 2.0]
    target_size = [bbox[2] - bbox[0], bbox[3] - bbox[1]]
    wc_z = target_size[1] + context_amount * sum(target_size)
    hc_z = target_size[0] + context_amount * sum(target_size)
    s_z = np.sqrt(wc_z * hc_z)
    scale_z = exemplar_size / s_z
    d_search = (instance_size - exemplar_size) / 2
    s_x = s_z + 2 * d_search / scale_z
    z = crop_hwc(image, pos_s_2_bbox(target_pos, s_z), exemplar_size, padding)
    x = crop_hwc(image, pos_s_2_bbox(target_pos, s_x), instance_size, padding)
    return z, x


def crop_video_frames(frame_paths, bboxes, track_id, out_dir,
                      instance_size=511, workers=4, reader=None,
                      writer=None):
    """Write {frame:06d}.{track:02d}.x.jpg crops for one track, each padded
    with its frame's per-channel mean. `reader` (default
    `imageio.read_image`) gives a frame's BGR uint8 array or None (the
    frame is skipped); `writer(path, image)` (default
    `imageio.write_image`) stores a crop."""
    reader = reader or imageio.read_image
    writer = writer or imageio.write_image
    os.makedirs(out_dir, exist_ok=True)

    def one(args):
        idx, (path, bbox) = args
        im = reader(path)
        if im is None:
            return
        avg = np.mean(im, axis=(0, 1))
        _, x = crop_like_siamfc(im, bbox, instance_size=instance_size,
                                padding=avg)
        writer(join(out_dir, "{:06d}.{:02d}.x.jpg".format(
            idx, int(track_id))), x)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(one, enumerate(zip(frame_paths, bboxes))))


def calc_corner_score(bbox, frame_sz, cut_ratio=1 / 32):
    """Per-frame corner score in [-1, 0]: penalty for boxes at the margin
    (ref: gen_json.py:244-254 behavior: 0 center, negative at corners)."""
    w, h = frame_sz[0], frame_sz[1]
    ax = [cut_ratio * w, cut_ratio * h, (1 - cut_ratio) * w,
          (1 - cut_ratio) * h]
    x1, y1, x2, y2 = bbox[:4]
    x_at = (x1 < ax[0] + 10) or (x2 > ax[2] - 10)
    y_at = (y1 < ax[1] + 10) or (y2 > ax[3] - 10)
    if x_at and y_at:
        return -1.0
    if x_at or y_at:
        return -0.3
    return 0.0


def memory_bounds(bbox_seq_list, idx, search_gap=2, max_frame_gap=320,
                  iou_threshold=0.45, quality_threshold=0.40):
    """Two-pointer [T_l, T_u] scan for one frame (ref: gen_json.py:114-167).

    bbox_seq_list: per-frame [x1,y1,x2,y2, st_freq, ...] lists.
    """
    n = len(bbox_seq_list)

    left_ptr = idx - search_gap
    prev = bbox_seq_list[idx]
    while True:
        if left_ptr < max(0, idx - max_frame_gap):
            left_ptr += search_gap
            break
        cur = bbox_seq_list[left_ptr]
        if diou_modify(cur[:4], prev[:4]) < iou_threshold \
                or cur[4] <= quality_threshold:
            left_ptr += search_gap
            break
        left_ptr -= search_gap
        prev = cur

    right_ptr = idx + search_gap
    prev = bbox_seq_list[idx]
    while True:
        if right_ptr >= min(n, idx + max_frame_gap):
            right_ptr -= search_gap
            break
        cur = bbox_seq_list[right_ptr]
        if diou_modify(cur[:4], prev[:4]) < iou_threshold \
                or cur[4] <= quality_threshold:
            right_ptr -= search_gap
            break
        right_ptr += search_gap
        prev = cur

    left_ptr = min(left_ptr + search_gap // 2, idx)
    right_ptr = max(right_ptr - search_gap // 2, idx)
    return left_ptr, right_ptr


def build_train_json(raw_annotations: dict, search_gap=2, max_frame_gap=320,
                     prohibit_file: str | None = None,
                     quality_gate: bool = True):
    """raw: {video: {track_id: {'frames': [[x1,y1,x2,y2], ...],
                                'freq': [[st, lt], ...],
                                'meta': {bbox_picked_freq, corner_bbox_freq,
                                         frame_sz}}}}
    -> loader schema with per-frame 9-tuples and track filtering
    (ref: gen_json.py:100-181). prohibit_file optionally lists video names
    to drop (e.g. the GOT-10k prohibited-1000 list for VOT2020 entries,
    ref: gen_json.py:173-181)."""
    prohibited = set()
    if prohibit_file and os.path.exists(prohibit_file):
        with open(prohibit_file) as f:
            prohibited = {ln.strip() for ln in f if ln.strip()}
    out = {}
    for video, tracks in raw_annotations.items():
        if video in prohibited or video.split("/")[-1] in prohibited:
            continue
        video_out = {}
        for track_id, track in tracks.items():
            meta = track["meta"]
            freq = meta["bbox_picked_freq"]
            corner_freq = meta["corner_bbox_freq"]
            if quality_gate and (freq < 0.35 or corner_freq > 0.4
                                 or freq - corner_freq / 3 < 0.33):
                # pseudo-box quality gates (ref gen_json.py:100-181);
                # quality_gate=False keeps every track — smoke-test
                # pipelines with an untrained flow net have no hope of
                # passing the real thresholds
                continue
            frame_sz = meta["frame_sz"]
            frames = track["frames"]
            freqs = track["freq"]
            seq = [list(map(float, frames[i])) + list(map(float, freqs[i]))
                   for i in range(len(frames))]

            entry = {}
            last_bounds = None
            for idx in range(len(seq)):
                if idx > 0 and last_bounds is not None \
                        and last_bounds[1] >= idx:
                    t_l, t_u = last_bounds
                else:
                    t_l, t_u = memory_bounds(seq, idx, search_gap,
                                             max_frame_gap)
                    last_bounds = (t_l, t_u)
                corner_score = calc_corner_score(seq[idx][:4], frame_sz)
                entry[str(idx)] = seq[idx][:6] + [t_l, t_u, corner_score]
            entry["meta"] = {"bbox_picked_freq": freq,
                             "corner_bbox_freq": corner_freq}
            video_out[str(track_id)] = entry
        if video_out:
            out[video] = video_out
    return out


def save_train_json(annotations: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(annotations, f)
