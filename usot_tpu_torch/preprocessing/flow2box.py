"""Flow -> candidate boxes + DP smoothing (pseudo-label factory, host
side): the port's own copy of `usot_tpu/preprocessing/flow2box.py`.

NumPy/SciPy re-implementation of the reference's flow_utils
(ref: preprocessing/flow_module/flow_utils.py): margin-cut distance map,
two-threshold binarization, connected components with size/corner/aspect
heuristics, dynamic-programming box-sequence smoothing with modified DIoU
rewards — INCLUDING the documented "reversed interpolation" quirk
(ref: flow_utils.py:119-132) reproduced for parameter-coupling parity.

Morphology and labelling use scipy.ndimage with skimage's connectivity
(label: 8-connected; small-object/hole removal: 4-connected, the skimage
defaults). `smooth_bbox_dp` takes the generator of its ±3 px
perturbations as an argument (`rng`, a `np.random.RandomState`; None is
numpy's global state, as JAX's copy draws): `RandomState(s)` draws what
`np.random.seed(s)` does.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

_FOUR = ndimage.generate_binary_structure(2, 1)
_EIGHT = ndimage.generate_binary_structure(2, 2)


def remove_small_objects(mask: np.ndarray, min_size: int) -> np.ndarray:
    labels, n = ndimage.label(mask, structure=_FOUR)
    if n == 0:
        return mask
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    keep = np.zeros(n + 1, bool)
    keep[1:] = sizes >= min_size
    return keep[labels]


def remove_small_holes(mask: np.ndarray, max_size: int) -> np.ndarray:
    inv = ~mask
    labels, n = ndimage.label(inv, structure=_FOUR)
    if n == 0:
        return mask
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    fill = np.zeros(n + 1, bool)
    fill[1:] = sizes < max_size
    return mask | fill[labels]


def region_bboxes(mask: np.ndarray):
    """8-connected component bboxes as (min_row, min_col, max_row, max_col)
    with exclusive max, matching skimage regionprops .bbox."""
    labels, n = ndimage.label(mask, structure=_EIGHT)
    out = []
    for sl in ndimage.find_objects(labels):
        if sl is None:
            continue
        out.append((sl[0].start, sl[1].start, sl[0].stop, sl[1].stop))
    return out


def flow_to_bbox_single_group(distance, mean_distance, max_distance,
                              center_weight, mean_max_ratio, saliency_param,
                              top_n, area_weight=1, small_ratio=0.02,
                              border_ratio=0.7):
    h_c, w_c = distance.shape
    max_dis_index = np.unravel_index(np.argmax(distance), distance.shape)
    max_bboxs, max_scores = [], []

    if mean_distance < 0.05 or max_distance / mean_distance > saliency_param:
        threshold = mean_max_ratio * mean_distance \
            + (1 - mean_max_ratio) * max_distance
        mask = distance >= threshold
        mask = remove_small_objects(mask, 80)
        mask = remove_small_holes(mask, 80)

        for bbox in region_bboxes(mask):
            if (bbox[2] - bbox[0]) < h_c * small_ratio \
                    or (bbox[3] - bbox[1]) < w_c * small_ratio:
                continue
            area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
            if area < 50:
                continue
            center_score = center_weight * min(h_c - bbox[2], bbox[0]) \
                * min(w_c - bbox[3], bbox[1])
            score = center_score + area_weight * area
            if bbox[0] <= max_dis_index[0] <= bbox[2] \
                    and bbox[1] <= max_dis_index[1] <= bbox[3]:
                score *= 2
            if min(h_c - bbox[2], bbox[0]) <= 15:
                score /= 2
                if (bbox[3] - bbox[1]) > w_c * border_ratio:
                    continue
            if min(w_c - bbox[3], bbox[1]) <= 15:
                score /= 2
                if (bbox[2] - bbox[0]) > h_c * border_ratio:
                    continue
            if bbox[2] == bbox[0] \
                    or (bbox[3] - bbox[1]) / (bbox[2] - bbox[0]) > 6:
                continue
            if bbox[3] == bbox[1] \
                    or (bbox[2] - bbox[0]) / (bbox[3] - bbox[1]) > 6:
                continue

            insert_index = len(max_bboxs)
            for index in range(len(max_bboxs) - 1, -1, -1):
                if score > max_scores[index]:
                    insert_index = index
                else:
                    break
            if insert_index < top_n:
                max_bboxs.insert(insert_index,
                                 (bbox[1], bbox[0], bbox[3], bbox[2]))
                max_scores.insert(insert_index, score)
            if len(max_bboxs) > top_n:
                max_bboxs = max_bboxs[:top_n]
                max_scores = max_scores[:top_n]
    return max_bboxs


# (mean_max_ratio, center_weight) of flow_to_bbox's two groups
GROUPS = ((0.7, 0.5), (0.84, 0.5))
SALIENCY = 2.5


def distance_map(flow, cut_ratio=1 / 32):
    """The margin-cut map of each vector's distance from the mean
    vector: (distance (h', w'), its mean, its max)."""
    h, w, _ = flow.shape
    flow_clip = flow[int(h * cut_ratio):int(h * (1 - cut_ratio)),
                     int(w * cut_ratio):int(w * (1 - cut_ratio))]
    flow_aver = np.mean(flow_clip, axis=(0, 1))
    distance = np.sqrt(np.sum((flow_clip - flow_aver) ** 2, axis=2))
    return distance, distance.mean(), distance.max()


def flow_to_bbox(flow, cut_ratio=1 / 32):
    """flow: (H, W, 2) -> list of candidate (x1, y1, x2, y2)."""
    h, w, _ = flow.shape
    distance, mean_distance, max_distance = distance_map(flow, cut_ratio)

    max_bboxs = []
    for mean_max_ratio, center_weight in GROUPS:
        max_bboxs.extend(flow_to_bbox_single_group(
            distance, mean_distance, max_distance,
            center_weight=center_weight, mean_max_ratio=mean_max_ratio,
            saliency_param=SALIENCY, top_n=1))
    return [(b[0] + cut_ratio * w, b[1] + cut_ratio * h,
             b[2] + cut_ratio * w, b[3] + cut_ratio * h) for b in max_bboxs]


def diou_modify(bbox1, bbox2):
    """Modified DIoU: distance penalty x4.1, negatives x3
    (ref: flow_utils.py:209-252)."""
    bbox1 = np.asarray(bbox1, np.float64)
    bbox2 = np.asarray(bbox2, np.float64)
    w1, h1 = bbox1[2] - bbox1[0], bbox1[3] - bbox1[1]
    w2, h2 = bbox2[2] - bbox2[0], bbox2[3] - bbox2[1]
    area1, area2 = w1 * h1, w2 * h2
    cx1, cy1 = (bbox1[2] + bbox1[0]) / 2, (bbox1[3] + bbox1[1]) / 2
    cx2, cy2 = (bbox2[2] + bbox2[0]) / 2, (bbox2[3] + bbox2[1]) / 2

    inter = np.clip(np.minimum(bbox1[2:], bbox2[2:])
                    - np.maximum(bbox1[:2], bbox2[:2]), 0, 5000)
    inter_area = inter[0] * inter[1]
    inter_diag = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2
    outer = np.clip(np.maximum(bbox1[2:], bbox2[2:])
                    - np.minimum(bbox1[:2], bbox2[:2]), 0, 5000)
    outer_diag = outer[0] ** 2 + outer[1] ** 2
    union = area1 + area2 - inter_area
    diou = inter_area / union - (inter_diag / outer_diag) * 4.1
    if diou < 0:
        diou *= 3
    return diou


def smooth_bbox_dp(bboxes, length, gap=3, bbox_reward=-0.091,
                   max_dp_gap=100, rng=None):
    """DP over per-frame candidate boxes (ref: flow_utils.py:14-180).

    bboxes: list over sub-sampled frames of candidate box lists. rng: a
    `np.random.RandomState` for the perturbations (None: numpy's global
    state).
    Returns (bbox_feedback, picked_frame_index, bbox_found_freq,
             bbox_picked_freq, aver_vary).
    """
    uniform = np.random.uniform if rng is None else rng.uniform
    bbox_found_num = 0
    bbox_not_random = []
    bbox_index = 0
    for frame_index in range(gap, length - gap, gap):
        bboxs = bboxes[bbox_index]
        if len(bboxs) > 0:
            bbox_found_num += 1
            bbox_not_random.append((bboxs, frame_index))
        bbox_index += 1

    if not bbox_not_random:
        raise ValueError("no candidate boxes in video")

    min_distance_dp = [[bbox_reward] * len(bbox_not_random[0][0])]
    last_bbox_cut = [[(-1, -1)] * len(bbox_not_random[0][0])]

    for nr_index in range(1, len(bbox_not_random)):
        bboxs, frame_index = bbox_not_random[nr_index]
        dp_this, cut_this = [], []
        for bbox in bboxs:
            min_distance = bbox_reward
            min_distance_index = (-1, -1)
            for dp_index in range(max(0, nr_index - max_dp_gap), nr_index):
                last_bboxs, _ = bbox_not_random[dp_index]
                for sub_index, last_bbox in enumerate(last_bboxs):
                    iou_reward = -diou_modify(bbox, last_bbox)
                    distance = (min_distance_dp[dp_index][sub_index]
                                + iou_reward + bbox_reward)
                    if distance <= min_distance:
                        min_distance = distance
                        min_distance_index = (dp_index, sub_index)
            dp_this.append(min_distance)
            cut_this.append(min_distance_index)
        min_distance_dp.append(dp_this)
        last_bbox_cut.append(cut_this)

    last_index = (len(bbox_not_random) - 1, 0)
    min_distance = min_distance_dp[last_index[0]][last_index[1]]
    for nr_index in range(len(bbox_not_random) - 1, -1, -1):
        for sub_index in range(len(bbox_not_random[nr_index][0])):
            if min_distance_dp[nr_index][sub_index] <= min_distance:
                last_index = (nr_index, sub_index)
                min_distance = min_distance_dp[nr_index][sub_index]

    picked_bbox = []
    while last_index[1] != -1:
        bboxs, frame_index = bbox_not_random[last_index[0]]
        picked_bbox.insert(0, (bboxs[last_index[1]], frame_index))
        last_index = last_bbox_cut[last_index[0]][last_index[1]]

    bbox_feedback = []
    last_already_generated = -1
    picked_frame_index = []
    for bpi in range(len(picked_bbox)):
        bbox, frame_index = picked_bbox[bpi]
        picked_frame_index.append(frame_index)
        for j in range(last_already_generated + 1, frame_index):
            if bpi == 0:
                if min(list(bbox)) < 75:
                    bbox_perturbed = bbox
                else:
                    pert = uniform(-3, 3, size=4)
                    bbox_perturbed = tuple(bbox[k] + pert[k] for k in range(4))
                bbox_feedback.append(bbox_perturbed)
            else:
                last_bbox, _ = picked_bbox[bpi - 1]
                # Reference's documented "reversed" interpolation kept as-is
                ratio = (j - last_already_generated) \
                    / (frame_index - last_already_generated)
                bbox_feedback.append(tuple(
                    last_bbox[k] * ratio + bbox[k] * (1 - ratio)
                    for k in range(4)))
        bbox_feedback.append(bbox)
        last_already_generated = frame_index

    pending = length - len(bbox_feedback)
    last_bbox = bbox_feedback[-1]
    for _ in range(pending):
        if min(list(last_bbox)) < 50:
            bbox_perturbed = last_bbox
        else:
            pert = uniform(-3, 3, size=4)
            bbox_perturbed = tuple(last_bbox[k] + pert[k] for k in range(4))
        bbox_feedback.append(bbox_perturbed)

    assert length == len(bbox_feedback)

    total_vary = 0.0
    for i in range(length - 1):
        for j in range(4):
            total_vary += abs(bbox_feedback[i][j] - bbox_feedback[i + 1][j])
    aver_vary = total_vary / (length - 1)
    bbox_picked_freq = len(picked_bbox) / len(bboxes)
    bbox_found_freq = bbox_found_num / len(bboxes)
    return (bbox_feedback, picked_frame_index, bbox_found_freq,
            bbox_picked_freq, aver_vary)


def calc_nearby_bbox_freq(picked_frame_index, video_length,
                          search_range=None, gap=3):
    """Short/long-term frame quality (ref: flow_utils.py:417-460)."""
    if not search_range:
        search_range = [3, 10]
    search_range = [s * gap for s in search_range]
    freq = [[0] * video_length for _ in search_range]
    freq_max = [[0] * video_length for _ in search_range]

    for r_i, sr in enumerate(search_range):
        for v_i in range(gap, video_length - gap, gap):
            for sub_i in range(max(0, v_i - sr),
                               min(video_length - 1, v_i + sr) + 1):
                freq_max[r_i][sub_i] += 1
        for v_i in picked_frame_index:
            for sub_i in range(max(0, v_i - sr),
                               min(video_length - 1, v_i + sr) + 1):
                freq[r_i][sub_i] += 1

    return [[(freq[r_i][v_i] / freq_max[r_i][v_i])
             if freq_max[r_i][v_i] else 0.0
             for r_i in range(len(search_range))]
            for v_i in range(video_length)]


def calc_corner_bbox_freq(smoothed_bboxs, img_shape, cut_ratio=1 / 32):
    """Fraction of boxes hugging the margins (ref: flow_utils.py:463-484)."""
    corner = 0.0
    ax = [int(cut_ratio * img_shape[1]), int(cut_ratio * img_shape[0]),
          int((1 - cut_ratio) * img_shape[1]),
          int((1 - cut_ratio) * img_shape[0])]
    for x1, y1, x2, y2 in smoothed_bboxs:
        x_c = (x1 < ax[0] + 10) or (x2 > ax[2] - 10)
        y_c = (y1 < ax[1] + 10) or (y2 > ax[3] - 10)
        if x_c and y_c:
            corner += 1
        elif x_c or y_c:
            corner += 0.3
    return corner / len(smoothed_bboxs)
