"""USOT tracker: init/track state machine with the online memory queue.

Counterpart of `usot_tpu/tracker/tracker.py` (ref:
lib/tracker/usot_tracker.py): host crops and float64 postprocessing step
for step like the reference, network work through a `ModelRunner`. The
memory-queue segment sampling reproduces the reference index computation
exactly, INCLUDING its documented deviation (ref: usot_tracker.py:239-242).
"""
from __future__ import annotations

import numpy as np
import torch

from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.core.geometry import (feature_axis,
                                          image_bbox_to_pool_bbox,
                                          python2round, score_grid)
from usot_tpu_torch.tracker.config import TrackerConfig, load_test_yaml
from usot_tpu_torch.tracker.postprocess import (hanning_window,
                                                postprocess_response)


def _flip_lr(image: np.ndarray, bbox):
    """Horizontal flip + bbox transform (replaces imgaug Fliplr(1.0))."""
    flipped = image[:, ::-1].copy()
    w = image.shape[1]
    x1, y1, x2, y2 = bbox
    return flipped, [w - x2, y1, w - x1, y2]


def _clip_number(num, _max=127.0, _min=0.0):
    return max(_min, min(_max, num))


class USOTTracker:
    """init(im, target_pos, target_sz, runner) -> state;
    track(state, im) -> state. The runner fixes the device."""

    def __init__(self, info=None, hp: dict | None = None):
        self.info = info
        # Test-time hyper-parameters: defaults, then optional YAML override
        self.hp = dict(hp) if hp else None
        if self.hp is None and info is not None \
                and getattr(info, "yaml", None):
            self.hp = load_test_yaml(info.yaml)

    def _grids(self, p: TrackerConfig):
        gx, gy = score_grid(p.score_size, p.total_stride, p.instance_size)
        self.grid_to_search_x = gx.astype(np.float64)
        self.grid_to_search_y = gy.astype(np.float64)
        self.template_axis = feature_axis(p.tf_size, p.total_stride,
                                          p.exemplar_size)
        self.search_axis = feature_axis(p.sf_size, p.total_stride,
                                        p.instance_size)

    def pool_label_template(self, p, bbox):
        return image_bbox_to_pool_bbox(bbox, self.template_axis, p.tf_size,
                                       clip_gap=0.0)

    def pool_label_search(self, p, bbox):
        return image_bbox_to_pool_bbox(bbox, self.search_axis, p.sf_size,
                                       clip_gap=1.0)

    def init(self, im, target_pos, target_sz, runner):
        state = {}
        p = TrackerConfig()
        if self.hp:
            p.update(self.hp)

        state["im_h"] = im.shape[0]
        state["im_w"] = im.shape[1]

        # Small-object videos get the big search area (ref :44-49)
        p.instance_size = p.instance_of(target_sz, state["im_h"],
                                        state["im_w"])
        p.renew()
        p.sf_size = p.score_size
        self._grids(p)

        target_pos = np.asarray(target_pos, np.float64)
        target_sz = np.asarray(target_sz, np.float64)

        wc_z = target_sz[0] + p.context_amount * sum(target_sz)
        hc_z = target_sz[1] + p.context_amount * sum(target_sz)
        s_z = round(np.sqrt(wc_z * hc_z))

        avg_chans = np.mean(im, axis=(0, 1))
        z_crop, crop_info = get_subwindow(im, target_pos, p.exemplar_size,
                                          s_z, avg_chans, target_sz,
                                          need_bbox=True)
        template_bbox = self.pool_label_template(p, crop_info["template_bbox"])
        zf = runner.template(np.asarray(z_crop, np.float32), template_bbox)

        window = (hanning_window(p.score_size) if p.windowing == "cosine"
                  else np.ones((p.score_size, p.score_size)))

        state["p"] = p
        state["runner"] = runner
        state["avg_chans"] = avg_chans
        state["window"] = window
        state["target_pos"] = target_pos
        state["target_sz"] = target_sz
        state["zf"] = zf

        # ----- bootstrap the memory queue (ref :95-129) -----
        s_z_f = np.sqrt(wc_z * hc_z)
        scale_z = p.exemplar_size / s_z_f
        d_search = (p.instance_size - p.exemplar_size) / 2
        pad = d_search / scale_z
        s_x = s_z_f + 2 * pad

        x_crop, crop_info = get_subwindow(im, target_pos, p.instance_size,
                                          python2round(s_x), avg_chans,
                                          target_sz, need_bbox=True)
        search_bbox = crop_info["template_bbox"]
        mem_feat = runner.extract_memory_feature(
            x_hwc=np.asarray(x_crop, np.float32),
            search_bbox=self.pool_label_search(p, search_bbox))

        # Left-right flipped init patch as the second anchor feature
        x_aug, bbox_aug = _flip_lr(np.asarray(x_crop), search_bbox)
        bbox_aug = [
            _clip_number(bbox_aug[0], _max=x_aug.shape[1]),   # x vs width
            _clip_number(bbox_aug[1], _max=x_aug.shape[0]),   # y vs height
            _clip_number(bbox_aug[2], _max=x_aug.shape[1]),
            _clip_number(bbox_aug[3], _max=x_aug.shape[0]),
        ]
        mem_feat_aug = runner.extract_memory_feature(
            x_hwc=x_aug.astype(np.float32),
            search_bbox=self.pool_label_search(p, bbox_aug))

        state["init_features"] = [mem_feat, mem_feat_aug]
        state["memory_features"] = [mem_feat]
        state["memory_confidences"] = [0.9]
        return state

    def _assemble_memory_queue(self, state, p):
        """2 init anchors + (N_q-3) best-of-segment + last (ref :222-256)."""
        memory_features = state["memory_features"]
        memory_confidences = state["memory_confidences"]
        template_mem = list(state["init_features"])
        score_mem = [0.9, 0.9]
        mem_length = len(memory_confidences)
        n_update = p.mem_queue_size - 3

        if mem_length <= 1:
            template_mem += [memory_features[0]] * (n_update + 1)
            score_mem += [memory_confidences[0]] * (n_update + 1)
        else:
            gap = (mem_length - 1) / n_update
            for i in range(n_update):
                # Documented deviation reproduced verbatim (ref :239-242)
                start_index = min(int(int(i * gap) * mem_length),
                                  mem_length - 1)
                end_index = min(int(int((i + 1) * gap) * mem_length),
                                mem_length - 1)
                if start_index >= end_index:
                    template_mem.append(memory_features[start_index])
                    score_mem.append(memory_confidences[start_index])
                else:
                    seg = np.array(memory_confidences[start_index:end_index])
                    max_index = int(np.argmax(seg)) + start_index
                    template_mem.append(memory_features[max_index])
                    score_mem.append(memory_confidences[max_index])
            template_mem.append(memory_features[-1])
            score_mem.append(memory_confidences[-1])

        return torch.cat(template_mem, dim=0), score_mem

    def track(self, state, im):
        p = state["p"]
        runner = state["runner"]
        target_pos = state["target_pos"]
        target_sz = state["target_sz"]

        hc_z = target_sz[1] + p.context_amount * sum(target_sz)
        wc_z = target_sz[0] + p.context_amount * sum(target_sz)
        s_z = np.sqrt(wc_z * hc_z)
        scale_z = p.exemplar_size / s_z
        d_search = (p.instance_size - p.exemplar_size) / 2
        pad = d_search / scale_z
        s_x = s_z + 2 * pad

        x_crop, _ = get_subwindow(im, target_pos, p.instance_size,
                                  python2round(s_x), state["avg_chans"])

        template_mem, _score_mem = self._assemble_memory_queue(state, p)

        xf = runner.search_features(np.asarray(x_crop, np.float32))
        cls_score, bbox_pred, cls_memory = runner.track_memory(
            xf, state["zf"], template_mem)

        new_pos, new_sz, best_score, pred_bbox_crop = postprocess_response(
            cls_score, cls_memory, bbox_pred,
            self.grid_to_search_x, self.grid_to_search_y, state["window"],
            target_pos, target_sz * scale_z, scale_z, p.instance_size,
            p.ratio, p.penalty_k, p.window_influence, p.lr)

        # Pool current-frame feature by the predicted bbox for the queue
        pred_pool_bbox = self.pool_label_search(p, pred_bbox_crop)
        feat_mem = runner.extract_memory_feature(xf=xf,
                                                 search_bbox=pred_pool_bbox)

        state["memory_features"].append(feat_mem)
        state["memory_confidences"].append(float(best_score))

        new_pos[0] = max(0, min(state["im_w"], new_pos[0]))
        new_pos[1] = max(0, min(state["im_h"], new_pos[1]))
        new_sz[0] = max(10, min(state["im_w"], new_sz[0]))
        new_sz[1] = max(10, min(state["im_h"], new_sz[1]))
        state["target_pos"] = new_pos
        state["target_sz"] = new_sz
        state["cls_score"] = float(best_score)
        return state
