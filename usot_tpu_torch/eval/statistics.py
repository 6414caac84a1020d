"""Evaluation statistics — vectorized NumPy re-implementations of the
reference's numba-JIT functions (ref: lib/eval_toolkit/pysot/utils/
statistics.py). The port's own copy of `usot_tpu/eval/statistics.py`:
the same numpy arithmetic, so the same numbers; no numba."""
from __future__ import annotations

import numpy as np

from usot_tpu_torch.eval.region import vot_overlap_traj


def calculate_failures(trajectory):
    """Failure indices: frames marked with the [2] restart flag."""
    failures = [i for i, x in enumerate(trajectory)
                if len(x) == 1 and x[0] == 2]
    return len(failures), failures


def calculate_accuracy(pred_trajectory, gt_trajectory, burnin=0,
                       ignore_unknown=True, bound=None):
    """Average overlap over a sequence; burnin frames after each re-init
    are zeroed out (ref behavior)."""
    pred = pred_trajectory
    if burnin > 0:
        pred = list(pred_trajectory)
        mask = [len(x) == 1 and x[0] == 1 for x in pred_trajectory]
        for i in range(len(mask)):
            if mask[i]:
                for j in range(burnin):
                    if i + j < len(mask):
                        pred[i + j] = [0]
    min_len = min(len(pred), len(gt_trajectory))
    overlaps = vot_overlap_traj(pred[:min_len], gt_trajectory[:min_len], bound)
    acc = np.nanmean(overlaps) if len(overlaps) > 0 else 0
    return acc, overlaps


def overlap_ratio(rect1, rect2):
    """IoU between N x [x,y,w,h] rect arrays."""
    rect1 = np.atleast_2d(rect1)
    rect2 = np.atleast_2d(rect2)
    left = np.maximum(rect1[:, 0], rect2[:, 0])
    right = np.minimum(rect1[:, 0] + rect1[:, 2], rect2[:, 0] + rect2[:, 2])
    top = np.maximum(rect1[:, 1], rect2[:, 1])
    bottom = np.minimum(rect1[:, 1] + rect1[:, 3], rect2[:, 1] + rect2[:, 3])
    intersect = np.maximum(0, right - left) * np.maximum(0, bottom - top)
    union = rect1[:, 2] * rect1[:, 3] + rect2[:, 2] * rect2[:, 3] - intersect
    iou = intersect / union
    return np.clip(iou, 0, 1)


def success_overlap(gt_bb, result_bb, n_frame):
    """Success curve: fraction of frames with IoU > t for 21 thresholds."""
    thresholds = np.arange(0, 1.05, 0.05)
    iou = np.ones(len(gt_bb)) * (-1)
    mask = np.sum(gt_bb > 0, axis=1) == 4
    iou[mask] = overlap_ratio(gt_bb[mask], result_bb[mask])
    return np.array([np.sum(iou > t) / float(n_frame) for t in thresholds])


def success_error(gt_center, result_center, thresholds, n_frame):
    """Precision curve: fraction of frames with center error <= t."""
    dist = np.ones(len(gt_center)) * (-1)
    mask = np.sum(gt_center > 0, axis=1) == 2
    dist[mask] = np.sqrt(
        np.sum((gt_center[mask] - result_center[mask]) ** 2, axis=1))
    return np.array([np.sum(dist <= t) / float(n_frame) for t in thresholds])


def determine_thresholds(scores, resolution=100):
    scores = np.sort(scores[np.logical_not(np.isnan(scores))])
    delta = np.floor(len(scores) / (resolution - 2))
    idxs = np.floor(np.linspace(delta - 1, len(scores) - delta,
                                resolution - 2) + 0.5).astype(np.int32)
    thresholds = np.zeros(resolution)
    thresholds[0] = -np.inf
    thresholds[-1] = np.inf
    thresholds[1:-1] = scores[idxs]
    return thresholds


def calculate_f1(overlaps, score, bound, thresholds, N):
    overlaps = np.array(overlaps)
    overlaps[np.isnan(overlaps)] = 0
    score = np.array(score)
    score[np.isnan(score)] = 0
    precision = np.zeros(len(thresholds))
    recall = np.zeros(len(thresholds))
    for i, th in enumerate(thresholds):
        idx = score > 0 if th == -np.inf else score >= th
        if np.sum(idx) == 0:
            precision[i] = 1
            recall[i] = 0
        else:
            precision[i] = np.mean(overlaps[idx])
            recall[i] = np.sum(overlaps[idx]) / N
    f1 = 2 * precision * recall / (precision + recall)
    return f1, precision, recall


def calculate_expected_overlap(fragments, fweights):
    """EAO curve: weighted mean of per-fragment running means."""
    max_len = fragments.shape[1]
    expected_overlaps = np.zeros(max_len, np.float32)
    expected_overlaps[0] = 1
    for i in range(1, max_len):
        mask = np.logical_not(np.isnan(fragments[:, i]))
        if np.any(mask):
            fragment = fragments[mask, 1:i + 1]
            seq_mean = np.sum(fragment, 1) / fragment.shape[1]
            expected_overlaps[i] = np.sum(
                seq_mean * fweights[mask]) / np.sum(fweights[mask])
    return expected_overlaps
