"""Training dataset: quality-gated sampling of pseudo-labelled video
frames. The port's copy of `usot_tpu/data/dataset.py` (ref:
lib/dataset_loader/datasets_usot.py), with the crops by
`cvops.warp_affine` and the frames read by a reader that the caller may
replace (default `data/imageio.read_image`; the GPU machine, which has
no image decoder, passes frames held in memory).

Two modes per the reference:
  naive Siamese — template and search cropped from the same frame
  cycle memory  — additionally N_mem memory search areas from the frame's
                  DP-validated [T_l, T_u] fragment, picking the farthest
                  memory_num of (memory_num + far_sample) candidates

Annotation schema per track: {frame_id: [x1,y1,x2,y2, st_freq, lt_freq,
T_l, T_u, corner_score], 'meta': {bbox_picked_freq, corner_bbox_freq}}.
Items are dicts of NHWC float32 arrays keyed for `train/step.py`. Every
random choice comes from `np.random.default_rng((seed, index))` and the
pick lists from `random.Random(seed)`, with JAX's calls in JAX's order:
the same config, seed and index give JAX's sample.
"""
from __future__ import annotations

import json
import os
import random
from os.path import join

import numpy as np

from usot_tpu_torch.core.geometry import (Center, Corner, aug_apply,
                                          center2corner, feature_axis,
                                          score_grid)
from usot_tpu_torch.data import cvops
from usot_tpu_torch.data.augment import MemoryAug, SearchAug, TemplateAug
from usot_tpu_torch.data.imageio import read_image, write_image

sample_random = random.Random()


def _clip_bbox_to_image(blist, shape):
    """Clip [x1, y1, x2, y2] into an (H, W, ...) image: x against width,
    y against height."""
    h, w = shape[0], shape[1]
    clip = lambda v, m: max(0.0, min(float(m), float(v)))
    return Corner(clip(blist[0], w), clip(blist[1], h),
                  clip(blist[2], w), clip(blist[3], h))


def _rng_choice(rng, seq):
    """Uniform pick from a sequence with a np.random.Generator."""
    return seq[int(rng.integers(0, len(seq)))]


class USOTDataset:
    def __init__(self, cfg, seed: int | None = None, reader=None):
        self.template_size = cfg.USOT.TRAIN.TEMPLATE_SIZE
        self.search_size = cfg.USOT.TRAIN.SEARCH_SIZE
        self.size = 25         # response map
        self.tf_size = 15
        self.sf_size = 25
        self.stride = cfg.USOT.TRAIN.STRIDE

        d = cfg.USOT.DATASET
        self.shift = d.SHIFT
        self.scale = d.SCALE
        self.shift_s = d.SHIFTs
        self.scale_s = d.SCALEs
        self.shift_m = d.SHIFTm
        self.scale_m = d.SCALEm
        self.video_quality = d.VIDEO_QUALITY
        self.memory_num = cfg.USOT.TRAIN.MEMORY_NUM
        self.far_sample = d.FAR_SAMPLE

        self.cycle_memory = True
        # path -> BGR uint8 (H, W, 3), or None where it cannot be read
        self.reader = reader or read_image
        # Set loader_test to a directory path to dump augmented crops with
        # drawn boxes for eyeballing (ref: datasets_usot.py loader_test)
        self.loader_test: str | None = None
        # Per-item generators are derived from this seed in __getitem__ so
        # threaded loader workers never share RNG state (np.random.Generator
        # is not thread-safe) and samples stay reproducible per index.
        self.seed = 0 if seed is None else int(seed)
        self.rng = np.random.default_rng(self.seed)
        # Pick-list shuffles are seeded from the dataset seed so two
        # loaders built with the same seed iterate identical samples.
        self._pick_random = random.Random(self.seed)

        self.template_aug = TemplateAug()
        self.search_aug = SearchAug()
        self.memory_aug = MemoryAug()

        self._grids()

        self.train_datas = []
        start = 0
        self.num = 0
        for data_name in cfg.USOT.TRAIN.WHICH_USE:
            sub = SubDataset(cfg, data_name, start, self.memory_num,
                             self.video_quality, self.far_sample,
                             pick_random=self._pick_random)
            self.train_datas.append(sub)
            start += sub.num
            self.num += sub.num_use
        self._shuffle()

    def __len__(self):
        return self.num

    def _shuffle(self):
        pick = []
        m = 0
        while m < self.num:
            p = []
            for subset in self.train_datas:
                p += subset.pick
            self._pick_random.shuffle(p)
            pick += p
            m = len(pick)
        self.pick = pick

    def _choose_dataset(self, index):
        for dataset in self.train_datas:
            if dataset.start + dataset.num > index:
                return dataset, index - dataset.start
        return self.train_datas[-1], index - self.train_datas[-1].start

    def _grids(self):
        gx, gy = score_grid(self.size, self.stride, self.search_size)
        self.grid_to_search_x = gx
        self.grid_to_search_y = gy
        self.template_axis = feature_axis(self.tf_size, self.stride,
                                          self.template_size)
        self.search_axis = feature_axis(self.sf_size, self.stride,
                                        self.search_size)

    # ----- labels -----

    def reg_label(self, bbox):
        x1, y1, x2, y2 = bbox
        l = self.grid_to_search_x - x1
        t = self.grid_to_search_y - y1
        r = x2 - self.grid_to_search_x
        b = y2 - self.grid_to_search_y
        reg_label = np.stack([l, t, r, b], axis=-1)
        inds_nonzero = (reg_label.min(axis=-1) > 0).astype(np.float32)
        return reg_label.astype(np.float32), inds_nonzero

    def pool_label_template(self, bbox):
        reg_min, reg_max = self.template_axis[0], self.template_axis[-1]
        bbox = np.clip(np.asarray(bbox, np.float32), reg_min, reg_max)
        slope = 2 * (self.tf_size // 2) / (reg_max - reg_min)
        return (bbox - reg_min) * slope

    def pool_label_search(self, bbox):
        reg_min, reg_max = self.search_axis[0], self.search_axis[-1]
        bbox = np.clip(np.asarray(bbox, np.float32), reg_min, reg_max)
        slope = 2 * (self.sf_size // 2) / (reg_max - reg_min)
        return (bbox - reg_min) * slope

    def dynamic_label(self, c_shift, r_pos=2):
        """BCE label disk (L1 distance <= r_pos), shifted by the aug shift
        (ref: datasets_usot.py:423-454)."""
        sz = self.size
        sz_x = sz // 2 + int(-c_shift[0] / self.stride)
        sz_y = sz // 2 + int(-c_shift[1] / self.stride)
        x, y = np.meshgrid(np.arange(sz) - np.floor(float(sz_x)),
                           np.arange(sz) - np.floor(float(sz_y)))
        dist = np.abs(x) + np.abs(y)
        return np.where(dist <= r_pos, 1.0, 0.0).astype(np.float32)

    # ----- crops & augmentation -----

    def _to_bbox(self, image, shape):
        imh, imw = image.shape[:2]
        if len(shape) == 4:
            w, h = shape[2] - shape[0], shape[3] - shape[1]
        else:
            w, h = shape
        context_amount = 0.5
        wc_z = w + context_amount * (w + h)
        hc_z = h + context_amount * (w + h)
        s_z = np.sqrt(wc_z * hc_z)
        scale_z = self.template_size / s_z
        w, h = w * scale_z, h * scale_z
        cx, cy = imw // 2, imh // 2
        return Corner(*center2corner(Center(cx, cy, w, h)))

    @staticmethod
    def _draw(image, box, name):
        """Debug dump of an augmented crop with its box, a 2-px outline
        in (0, 215, 255) (ref: datasets_usot.py:343-355)."""
        draw = np.array(image, np.uint8)
        if box is not None:
            h, w = draw.shape[:2]
            x1, y1, x2, y2 = (int(round(float(v))) for v in box)
            xa, xb = max(0, min(x1, x2) - 1), min(w, max(x1, x2) + 2)
            ya, yb = max(0, min(y1, y2) - 1), min(h, max(y1, y2) + 2)
            color = (0, 215, 255)
            draw[ya:ya + 2, xa:xb] = color
            draw[max(ya, yb - 2):yb, xa:xb] = color
            draw[ya:yb, xa:xa + 2] = color
            draw[ya:yb, max(xa, xb - 2):xb] = color
        os.makedirs(os.path.dirname(name), exist_ok=True)
        write_image(name, draw)

    @staticmethod
    def _crop_hwc(image, bbox, out_sz):
        """The `out_sz` square crop of `bbox`, black outside the image."""
        bbox = [float(x) for x in bbox]
        a = (out_sz - 1) / (bbox[2] - bbox[0])
        b = (out_sz - 1) / (bbox[3] - bbox[1])
        c = -a * bbox[0]
        d = -b * bbox[1]
        mapping = np.array([[a, 0, c], [0, b, d]], np.float64)
        return cvops.warp_affine(image, mapping, (out_sz, out_sz))

    def _read(self, path):
        image = self.reader(path)
        if image is None:
            raise FileNotFoundError(f"cannot read frame {path}")
        return image

    def _augmentation(self, image, bbox, size, search=False,
                      cycle_memory=False, rng=None):
        rng = rng if rng is not None else self.rng
        shape = image.shape
        crop_bbox = center2corner((shape[0] // 2, shape[1] // 2, size, size))

        def pn(scale):
            return (rng.random() * 2 - 1.0) * scale

        if not search:
            param = {"shift": (pn(self.shift), pn(self.shift)),
                     "scale": (1.0 + pn(self.scale), 1.0 + pn(self.scale))}
        elif not cycle_memory:
            param = {"shift": (pn(self.shift_s), pn(self.shift_s)),
                     "scale": (1.0 + pn(self.scale_s), 1.0 + pn(self.scale_s))}
        else:
            param = {"shift": (pn(self.shift_m), pn(self.shift_m)),
                     "scale": (1.0 + pn(self.scale_m), 1.0 + pn(self.scale_m))}

        crop_bbox, _ = aug_apply(Corner(*crop_bbox), param, shape)
        x1, y1 = crop_bbox.x1, crop_bbox.y1
        bbox = Corner(bbox.x1 - x1, bbox.y1 - y1, bbox.x2 - x1, bbox.y2 - y1)
        scale_x, scale_y = param["scale"]
        bbox = Corner(bbox.x1 / scale_x, bbox.y1 / scale_y,
                      bbox.x2 / scale_x, bbox.y2 / scale_y)
        image = self._crop_hwc(image, crop_bbox, size)

        blist = [bbox.x1, bbox.y1, bbox.x2, bbox.y2]
        if not search:
            image, blist = self.template_aug(image, blist, rng)
        elif not cycle_memory:
            image, blist = self.search_aug(image, blist, rng)
        else:
            image, blist = self.memory_aug(image, blist, rng)

        bbox = _clip_bbox_to_image(blist, image.shape)
        return image, bbox, param["shift"]

    # ----- item assembly -----

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, int(index)))
        index = self.pick[index % len(self.pick)]
        dataset, index = self._choose_dataset(index)
        pair_info = dataset.get_instances(index, self.cycle_memory, rng=rng)

        search_image = self._read(pair_info[0])
        search_bbox = self._to_bbox(search_image, pair_info[1])
        template_image = search_image

        template_aug, bbox_t, _ = self._augmentation(
            template_image, search_bbox, self.template_size, rng=rng)
        search_aug, bbox_s, shift_s = self._augmentation(
            search_image, search_bbox, self.search_size, search=True,
            rng=rng)

        if self.loader_test:
            tag = f"{int(rng.integers(0, 999999)):06d}"
            self._draw(search_aug, bbox_s,
                       join(self.loader_test, tag + "_s.jpg"))
            self._draw(template_aug, bbox_t,
                       join(self.loader_test, tag + "_t.jpg"))

        out = {
            "template": template_aug.astype(np.float32),
            "search": search_aug.astype(np.float32),
            "label": self.dynamic_label(shift_s),
        }
        reg_label, reg_weight = self.reg_label(bbox_s)
        out["reg_target"] = reg_label
        out["reg_weight"] = reg_weight
        out["template_bbox"] = np.asarray(
            self.pool_label_template(list(bbox_t)), np.float32)

        if self.cycle_memory:
            mems = []
            for i, path in enumerate(pair_info[2]):
                im = self._read(path)
                bb = self._to_bbox(im, pair_info[3][i])
                crop, _, _ = self._augmentation(im, bb, self.search_size,
                                                search=True,
                                                cycle_memory=True, rng=rng)
                mems.append(crop.astype(np.float32))
            out["search_memory"] = np.stack(mems)
            out["search_bbox"] = np.asarray(
                self.pool_label_search(list(bbox_s)), np.float32)
        return out


class SubDataset:
    """One source dataset (VID/GOT10K/LASOT/YTVOS) with quality-gated video
    and frame sampling (ref: datasets_usot.py:457-827)."""

    def __init__(self, cfg, data_name, start, memory_num, video_quality,
                 far_sample, pick_random=None):
        self._pick_random = pick_random if pick_random is not None \
            else sample_random
        self.data_name = data_name
        self.start = start
        info = cfg.USOT.DATASET[data_name]
        self.root = info.PATH
        with open(info.ANNOTATION) as fin:
            self.labels = json.load(fin)
            self._clean()
            self.num = len(self.labels)
        self.num_use = info.USE
        self.memory_num = memory_num
        self.video_quality = video_quality
        self.far_sample = far_sample
        self._shuffle()

    def _clean(self):
        to_del = [v for v in self.labels if len(self.labels[v]) <= 0]
        for v in to_del:
            del self.labels[v]
        self.videos = list(self.labels.keys())

    def _shuffle(self):
        lists = list(range(self.start, self.start + self.num))
        pick = []
        m = 0
        while m < self.num_use:
            self._pick_random.shuffle(lists)
            pick += lists
            m += self.num
        self.pick = pick[:self.num_use]

    @staticmethod
    def _video_quality_score(freq, corner_freq):
        return freq - corner_freq / 3

    @staticmethod
    def _short_term_quality(bbox_info):
        return bbox_info[4] + 2 / 3 * bbox_info[8]

    @staticmethod
    def _long_term_quality(bbox_info, video_len):
        return (bbox_info[4] + 0.5 * bbox_info[8]
                + (bbox_info[7] - bbox_info[6]) / (video_len * 2))

    def _frame_path(self, video, track_id, frame_id):
        fid = "0" * (8 - len(frame_id)) + frame_id
        return join(self.root, video, f"{fid[-6:]}.{track_id}.x.jpg")

    def _pick_best_frame(self, track_info, quality_fn, rng):
        frames = [f for f in track_info.keys() if f != "meta"]
        video_len = len(frames)
        freq = track_info["meta"]["bbox_picked_freq"]
        n_cand = int((1.0 / freq) * 3)
        cands = rng.choice(video_len, n_cand, replace=True)
        qualities = np.array([quality_fn(track_info[frames[c]], video_len)
                              for c in cands])
        return frames, int(cands[int(np.argmax(qualities))])

    def _resample_video(self, video_index, rng):
        """Quality-driven re-sampling from +-30 nearby videos
        (ref: datasets_usot.py:604-666)."""
        total = len(self.labels)
        cand_range = np.arange(max(0, video_index - 30),
                               min(total - 1, video_index + 31))
        max_tries = 20
        best_video, track_id = None, None
        while max_tries:
            picked = rng.choice(cand_range, 3, replace=True)
            names = [self.videos[c] for c in picked]
            tracks = [_rng_choice(rng, list(self.labels[n].keys()))
                      for n in names]
            metas = [self.labels[n][t]["meta"] for n, t in zip(names, tracks)]
            scores = np.array([
                self._video_quality_score(m["bbox_picked_freq"],
                                          m["corner_bbox_freq"])
                for m in metas])
            best = int(np.argmax(scores))
            best_video, track_id = picked[best], tracks[best]
            if scores[best] > self.video_quality:
                break
            max_tries -= 1
        if best_video is None or track_id is None:
            best_video = int(rng.choice(cand_range, 1)[0])
            track_id = _rng_choice(
                rng, list(self.labels[self.videos[best_video]].keys()))
        return self.videos[int(best_video)], track_id

    def _sample_memory_frames(self, track_info, frames, frame_idx, rng):
        frame_id = frames[frame_idx]
        info = track_info[frame_id]
        search_range = np.arange(info[6], info[7] + 1)
        picked = rng.choice(search_range,
                            self.memory_num + self.far_sample,
                            replace=True)
        interval = np.abs(picked - frame_idx)
        select = interval.argsort()[::-1][: self.memory_num]
        return [frames[int(c)] for c in picked[select]]

    def get_instances(self, index, cycle_memory=False, rng=None):
        # rng threads per-item randomness through every sampling decision:
        # global np.random/random would race under the threaded loader and
        # break per-index reproducibility (the aug path already does this)
        rng = rng if rng is not None else np.random.default_rng()
        video_name = self.videos[index]
        track_id = _rng_choice(rng, list(self.labels[video_name].keys()))
        track_info = self.labels[video_name][track_id]

        meta = track_info["meta"]
        score = self._video_quality_score(meta["bbox_picked_freq"],
                                          meta["corner_bbox_freq"])
        if not (score >= self.video_quality
                and meta["corner_bbox_freq"] < 0.25):
            video_name, track_id = self._resample_video(index, rng)
            track_info = self.labels[video_name][track_id]

        if cycle_memory:
            frames, fidx = self._pick_best_frame(
                track_info, self._long_term_quality, rng)
        else:
            frames, fidx = self._pick_best_frame(
                track_info, lambda info, _len: self._short_term_quality(info),
                rng)

        frame_id = frames[fidx]
        image_path = self._frame_path(video_name, track_id, frame_id)
        bbox = track_info[frame_id][:4]
        if not cycle_memory:
            return image_path, bbox

        mem_ids = self._sample_memory_frames(track_info, frames, fidx, rng)
        mem_paths = [self._frame_path(video_name, track_id, f)
                     for f in mem_ids]
        mem_bboxes = [track_info[f][:4] for f in mem_ids]
        return image_path, bbox, mem_paths, mem_bboxes
