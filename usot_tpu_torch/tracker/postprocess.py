"""Response-map postprocessing: scale/ratio penalties, Hanning window,
argmax decode, size EMA (ref: lib/tracker/usot_tracker.py:133-200).

The port's own copy of the float64 numpy path of
`usot_tpu/tracker/postprocess.py`.
"""
from __future__ import annotations

import numpy as np


def hanning_window(score_size: int) -> np.ndarray:
    h = np.hanning(score_size)
    return np.outer(h, h)


def _change(r):
    return np.maximum(r, 1.0 / r)


def _sz(w, h):
    pad = (w + h) * 0.5
    return np.sqrt((w + pad) * (h + pad))


def postprocess_response(cls_score, cls_memory, bbox_pred, grid_x, grid_y,
                         window, target_pos, target_sz_scaled, scale_z,
                         instance_size, p_ratio, p_penalty_k,
                         p_window_influence, p_lr):
    """Decode one frame.

    cls_score: (S, S) sigmoid offline score; cls_memory: (S, S) sigmoid
    online score or None; bbox_pred: (4, S, S) ltrb offsets;
    grid_x/grid_y/window: (S, S); target_pos: (2,) image coords;
    target_sz_scaled: (2,) search-crop scale; scale_z: scalar.

    Returns (new_pos (2,), new_sz (2,), best_score,
             pred_bbox_crop (4,) [x1,y1,x2,y2] in crop coords)."""
    if cls_memory is not None:
        cls_score = p_ratio * cls_score + (1 - p_ratio) * cls_memory

    pred_x1 = grid_x - bbox_pred[0]
    pred_y1 = grid_y - bbox_pred[1]
    pred_x2 = grid_x + bbox_pred[2]
    pred_y2 = grid_y + bbox_pred[3]

    w, h = target_sz_scaled[0], target_sz_scaled[1]
    s_c = _change(_sz(pred_x2 - pred_x1, pred_y2 - pred_y1) / _sz(w, h))
    r_c = _change((w / h) / ((pred_x2 - pred_x1) / (pred_y2 - pred_y1)))
    penalty = np.exp(-(r_c * s_c - 1) * p_penalty_k)
    pscore = penalty * cls_score
    pscore = pscore * (1 - p_window_influence) + window * p_window_influence
    # Degenerate predictions (inf/inf box ratios) give NaN cells; keep
    # them out of the argmax (no-op for healthy checkpoints).
    pscore = np.where(np.isnan(pscore), -np.inf, pscore)

    r_max, c_max = np.unravel_index(pscore.argmax(), pscore.shape)

    bx1 = pred_x1[r_max, c_max]
    by1 = pred_y1[r_max, c_max]
    bx2 = pred_x2[r_max, c_max]
    by2 = pred_y2[r_max, c_max]

    pred_xs = (bx1 + bx2) / 2
    pred_ys = (by1 + by2) / 2
    pred_w = (bx2 - bx1) / scale_z
    pred_h = (by2 - by1) / scale_z

    diff_xs = (pred_xs - instance_size // 2) / scale_z
    diff_ys = (pred_ys - instance_size // 2) / scale_z

    target_sz_img = target_sz_scaled / scale_z

    lr = penalty[r_max, c_max] * cls_score[r_max, c_max] * p_lr

    res_w = pred_w * lr + (1 - lr) * target_sz_img[0]
    res_h = pred_h * lr + (1 - lr) * target_sz_img[1]

    new_pos = np.array([target_pos[0] + diff_xs, target_pos[1] + diff_ys])
    new_sz = np.array([target_sz_img[0] * (1 - lr) + lr * res_w,
                       target_sz_img[1] * (1 - lr) + lr * res_h])

    best_score = cls_score[r_max, c_max]
    pred_bbox_crop = np.array([bx1, by1, bx2, by2])
    return new_pos, new_sz, best_score, pred_bbox_crop
