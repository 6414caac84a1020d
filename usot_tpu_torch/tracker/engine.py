"""Scan tracking engines: the whole per-frame step (crop, backbone, heads,
postprocess, memory-queue sampling and ring write) stays on the device,
and positions, sizes and scores come back once per chunk of frames.

Counterpart of `usot_tpu/tracker/engine.py:33-896,1445-1473`. JAX scans
the step inside one jitted program; here a chunk is a plain Python loop
over frames that launches device work only: no `.item()`, no copy to the
host, no `nonzero` and no Python branch on device data inside a chunk, so
the host never waits for the card until the chunk's outputs are read
(and a later CUDA-graph capture of the step stays possible).

`ScanEngine` tracks one video; `BatchScanEngine` tracks B videos in
lockstep. Both run one batched step (`_frame_step_batched`), the single
video as a batch of one: `vmap` becomes a batch dimension written out.
The carry (`EngineState`) keeps the JAX package's fields and layouts: the
template and the memory frames are carried ENCODED, and the memory ring
has MAX + 1 slots, the last a scratch slot that takes the writes of
invalid (padding) frames. The ring tensors are written in place; the
small bookkeeping fields are new tensors every frame, so
`_freeze_invalid` can select between the old and the new values.

Not carried over: `impl="vmap"`, `unroll`, `mesh`, `carry_dtype` (the
port runs f32), ROI streaming and lane surgery (`engine.py:898-1443`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from usot_tpu_torch.core.crop import get_subwindow, subwindow_gather
from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.core.geometry import (feature_axis, python2round,
                                          score_grid)
from usot_tpu_torch.models.head import fold_inference_head
from usot_tpu_torch.models.usot import USOTNet
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.postprocess import hanning_window
from usot_tpu_torch.tracker.tracker import _clip_number, _flip_lr


class EngineState(NamedTuple):
    """Tracking carry of one video (`BatchScanEngine` adds a leading B
    dim to every tensor). Layouts as `usot_tpu.tracker.engine`."""
    pos: Any          # (2,) f32 image coords
    sz: Any           # (2,) f32
    zf_enc: Any       # (cls_z, reg_z): two 3-tuples of (1, h_i, w_i, C)
    init_enc: Any     # 3-tuple of (2, h_i, w_i, C) encoded init anchors
    mem_enc: Any      # 3-tuple of (MAX + 1, h_i, w_i, C) encoded ring
    mem_conf: Any     # (MAX,) f32
    mem_idx: Any      # (MAX,) int32 logical frame index per slot (-1 empty)
    mem_len: Any      # () int32 LOGICAL history length (grows unbounded)


# ------------------------------------------------------------ ring logic
# These work on the last axis, for one video ((S,) and ()) or a batch
# ((B, S) and (B,)) alike. torch.argmax/argmin return the FIRST extremal
# index, as jnp.argmax/argmin do; bool masks are cast to int first
# (argmax is not defined for bool on CUDA).

def _write_slot(mem_conf, mem_idx, mem_len, max_frames: int):
    """Ring slot to write the newest frame into (see
    `usot_tpu/tracker/engine.py:52-82` for why min-eviction is pick-exact
    against the reference's unbounded history). While the ring has room,
    slot s holds logical frame s; once full, the lowest-confidence slot
    is evicted, never the newest frame, ties broken toward the LARGEST
    logical index. Returns int64 slots, shape of mem_len."""
    full = mem_len >= max_frames
    last_slot = mem_idx.argmax(dim=-1)
    conf_evict = mem_conf.scatter(-1, last_slot[..., None], float("inf"))
    tied = conf_evict == conf_evict.amin(dim=-1, keepdim=True)
    evict = torch.where(tied, mem_idx, -1).argmax(dim=-1)
    return torch.where(full, evict,
                       torch.clamp(mem_len, max=max_frames - 1).long())


def _memory_write_multi_batched(rings, mem_conf, mem_idx, mem_len, feats,
                                score, valid=None):
    """Append one frame per lane to N parallel rings sharing one
    confidence/index bookkeeping.

    rings[i]: (B, S', h, w, C) with S' = S + 1 (scratch slot) or S;
    mem_conf (B, S); mem_idx (B, S) int32; mem_len (B,) int32;
    feats[i]: (B, 1, h, w, C); score (B,); valid (B,) bool or None.

    The rings are written IN PLACE (one `index_copy_` per ring, into each
    lane's own slot; an invalid lane writes its scratch slot S, so its
    real slots stay untouched) and returned. JAX picks between a block
    write and this scatter with `lax.cond` (`engine.py:164`), a TPU
    memory optimisation; a branch on device data would stall the host
    here, and the scatter is exact in both regimes. The bookkeeping
    fields come back as new tensors, for the caller's freeze select."""
    b, s = mem_conf.shape
    write_idx = _write_slot(mem_conf, mem_idx, mem_len, s)          # (B,)
    ring_idx = write_idx if valid is None \
        else torch.where(valid, write_idx, s)
    lanes = torch.arange(b, device=mem_conf.device)
    for r, f in zip(rings, feats):
        flat = r.view((b * r.shape[1],) + tuple(r.shape[2:]))
        flat.index_copy_(0, lanes * r.shape[1] + ring_idx,
                         f[:, 0].to(r.dtype))
    mem_conf = mem_conf.scatter(1, write_idx[:, None], score[:, None])
    mem_idx = mem_idx.scatter(1, write_idx[:, None], mem_len[:, None])
    return rings, mem_conf, mem_idx, mem_len + 1


def _memory_write_multi(rings, mem_conf, mem_idx, mem_len, feats, score,
                        valid=None):
    """One video's append (rings[i]: (S', h, w, C); feats[i]:
    (1, h, w, C); mem_conf/mem_idx (S,); mem_len, score, valid ()):
    `_memory_write_multi_batched` on a batch of one."""
    _, mem_conf, mem_idx, mem_len = _memory_write_multi_batched(
        tuple(r[None] for r in rings), mem_conf[None], mem_idx[None],
        mem_len[None], tuple(f[None] for f in feats), score[None],
        None if valid is None else valid[None])
    return rings, mem_conf[0], mem_idx[0], mem_len[0]


def _queue_picks(mem_conf, mem_idx, mem_len, n_queue: int):
    """On-device replica of the reference memory-queue sampling (ref:
    usot_tracker.py:222-256, incl. its documented index deviation), in
    f32 as `usot_tpu/tracker/engine.py:171-213`. Segment bounds are
    LOGICAL frame indices; slots are matched by their stored logical
    index, so eviction is transparent. Returns (..., n_queue - 2) int64
    ring slots."""
    n_update = n_queue - 3
    length = mem_len.to(torch.float32)[..., None]                  # (..., 1)
    last_slot = mem_idx.argmax(dim=-1)
    big = torch.iinfo(torch.int32).max
    gap = (length - 1.0) / n_update
    picks = []
    for i in range(n_update):
        start = torch.minimum(torch.floor(torch.floor(i * gap) * length),
                              length - 1.0).to(torch.int32)
        end = torch.minimum(torch.floor(torch.floor((i + 1) * gap) * length),
                            length - 1.0).to(torch.int32)
        in_seg = (mem_idx >= start) & (mem_idx < end)
        masked = torch.where(in_seg, mem_conf, float("-inf"))
        # np.argmax over the logical list takes the FIRST maximum: break
        # ties toward the smallest logical index, not the smallest slot
        seg_tied = in_seg & (masked == masked.amax(dim=-1, keepdim=True))
        first_max = torch.where(seg_tied, mem_idx, big).argmin(dim=-1)
        seg_best = torch.where(in_seg.any(dim=-1), first_max, last_slot)
        at_start = mem_idx == start
        slot_of_start = torch.where(at_start.any(dim=-1),
                                    at_start.to(torch.int32).argmax(dim=-1),
                                    last_slot)
        picks.append(torch.where((start >= end)[..., 0], slot_of_start,
                                 seg_best))
    picks.append(last_slot)
    picks = torch.stack(picks, dim=-1)
    # mem_len <= 1: every sampled slot reads frame 0
    return torch.where((mem_len <= 1)[..., None], 0, picks)


def _gather_slots(ring, picks):
    """ring (B, S', h, w, C), picks (B, k) -> (B, k, h, w, C)."""
    b, slots = ring.shape[0], ring.shape[1]
    flat = ring.view((b * slots,) + tuple(ring.shape[2:]))
    lanes = torch.arange(b, device=ring.device)[:, None] * slots
    out = flat.index_select(0, (lanes + picks).reshape(-1))
    return out.reshape((b, picks.shape[1]) + tuple(ring.shape[2:]))


def _freeze_invalid(new: EngineState, old: EngineState, is_valid):
    """Padding-frame carry freeze on the cheap fields only: the rings are
    untouched on invalid frames by construction (scratch-slot write) and
    the template/init encodings never change. is_valid: () or (B,)."""
    def keep(n, o):
        shape = tuple(is_valid.shape) + (1,) * (n.dim() - is_valid.dim())
        return torch.where(is_valid.reshape(shape), n, o)

    return EngineState(
        pos=keep(new.pos, old.pos), sz=keep(new.sz, old.sz),
        zf_enc=new.zf_enc, init_enc=new.init_enc, mem_enc=new.mem_enc,
        mem_conf=keep(new.mem_conf, old.mem_conf),
        mem_idx=keep(new.mem_idx, old.mem_idx),
        mem_len=keep(new.mem_len, old.mem_len))


# --------------------------------------------------------- postprocess

def make_consts(p: TrackerConfig, device=None) -> dict:
    """Per-config postprocess constants on `device`: score grid, cosine
    window, and the search-feature-axis scaling for the pool bbox."""
    dev = resolve_device(device)
    gx, gy = score_grid(p.score_size, p.total_stride, p.instance_size)
    window = hanning_window(p.score_size)
    sf_axis = feature_axis(p.sf_size, p.total_stride, p.instance_size)
    return dict(
        gx=torch.as_tensor(gx, device=dev),
        gy=torch.as_tensor(gy, device=dev),
        window=torch.as_tensor(window, dtype=torch.float32, device=dev),
        sf_min=float(sf_axis[0]), sf_max=float(sf_axis[-1]),
        sf_slope=(2 * (p.sf_size // 2)) / float(sf_axis[-1] - sf_axis[0]),
    )


def _postprocess_traced(p, c, pos, sz, scale_z, cls, bbox, cls_mem):
    """On-device postprocess of a batch of videos, in f32: penalties,
    cosine window, argmax, size EMA, pool bbox (counterpart of
    `usot_tpu/tracker/engine.py:260-332`, which JAX vmaps over videos).

    pos, sz: (B, 2); scale_z: (B,); cls/bbox/cls_mem: (B, S, S, {1,4,1})
    raw head outputs; c: `make_consts`. Returns (new_pos (B, 2),
    new_sz (B, 2), best_score (B,), pool_bbox (B, 4))."""
    b = pos.shape[0]
    cls = cls.to(torch.float32)
    bbox = bbox.to(torch.float32)
    cls_mem = cls_mem.to(torch.float32)
    cls_score = torch.sigmoid(cls[..., 0])                   # (B, S, S)
    cls_memory = torch.sigmoid(cls_mem[..., 0])
    cls_score = p.ratio * cls_score + (1 - p.ratio) * cls_memory

    pred_x1 = c["gx"] - bbox[..., 0]
    pred_y1 = c["gy"] - bbox[..., 1]
    pred_x2 = c["gx"] + bbox[..., 2]
    pred_y2 = c["gy"] + bbox[..., 3]

    target_sz_crop = sz * scale_z[:, None]
    w = target_sz_crop[:, 0, None, None]
    h = target_sz_crop[:, 1, None, None]

    def _sz(a, bb):
        pad = (a + bb) * 0.5
        return torch.sqrt((a + pad) * (bb + pad))

    def _change(r):
        return torch.maximum(r, 1.0 / r)

    s_c = _change(_sz(pred_x2 - pred_x1, pred_y2 - pred_y1) / _sz(w, h))
    r_c = _change((w / h) / ((pred_x2 - pred_x1) / (pred_y2 - pred_y1)))
    penalty = torch.exp(-(r_c * s_c - 1) * p.penalty_k)
    pscore = penalty * cls_score
    pscore = pscore * (1 - p.window_influence) \
        + c["window"] * p.window_influence
    # Degenerate-prediction guard (see postprocess.py): NaN cells lose
    pscore = torch.where(torch.isnan(pscore), float("-inf"), pscore)
    best = pscore.reshape(b, -1).argmax(dim=1, keepdim=True)   # (B, 1)

    def at(t):
        return t.reshape(b, -1).gather(1, best)[:, 0]

    bx1, by1, bx2, by2 = at(pred_x1), at(pred_y1), at(pred_x2), at(pred_y2)
    pred_xs = (bx1 + bx2) / 2
    pred_ys = (by1 + by2) / 2
    diff_xs = (pred_xs - p.instance_size // 2) / scale_z
    diff_ys = (pred_ys - p.instance_size // 2) / scale_z
    pred_w = (bx2 - bx1) / scale_z
    pred_h = (by2 - by1) / scale_z

    best_score = at(cls_score)
    lr = at(penalty) * best_score * p.lr
    res_w = pred_w * lr + (1 - lr) * sz[:, 0]
    res_h = pred_h * lr + (1 - lr) * sz[:, 1]
    new_pos = torch.stack([pos[:, 0] + diff_xs, pos[:, 1] + diff_ys], -1)
    new_sz = torch.stack([sz[:, 0] * (1 - lr) + lr * res_w,
                          sz[:, 1] * (1 - lr) + lr * res_h], -1)

    # Pool this frame's feature by the predicted crop bbox
    gap = 1.0 / c["sf_slope"]
    crop_bbox = torch.stack([bx1, by1, bx2, by2], -1)
    crop_bbox = torch.clamp(crop_bbox, c["sf_min"] - gap, c["sf_max"] + gap)
    pool_bbox = (crop_bbox - c["sf_min"]) * c["sf_slope"]
    return new_pos, new_sz, best_score, pool_bbox


# -------------------------------------------------------------- engines

def _lift(state: EngineState) -> EngineState:
    """One video's carry as a batch of one (views, no copies)."""
    return EngineState(
        pos=state.pos[None], sz=state.sz[None],
        zf_enc=tuple(tuple(t[None] for t in side) for side in state.zf_enc),
        init_enc=tuple(t[None] for t in state.init_enc),
        mem_enc=tuple(t[None] for t in state.mem_enc),
        mem_conf=state.mem_conf[None], mem_idx=state.mem_idx[None],
        mem_len=state.mem_len[None])


def _drop(state: EngineState) -> EngineState:
    return EngineState(
        pos=state.pos[0], sz=state.sz[0],
        zf_enc=tuple(tuple(t[0] for t in side) for side in state.zf_enc),
        init_enc=tuple(t[0] for t in state.init_enc),
        mem_enc=tuple(t[0] for t in state.mem_enc),
        mem_conf=state.mem_conf[0], mem_idx=state.mem_idx[0],
        mem_len=state.mem_len[0])


class ScanEngine:
    """Chunked on-device tracker of one video of a fixed (im_h, im_w).

    model: a `USOTNet` with its weights (moved to `device`); device None
    means the GPU (raises without one unless device="cpu"). The crop is
    `subwindow_gather`, JAX's choice off the TPU. fused_head: run the
    heads on folded BN weights (`fold_inference_head`, computed once
    here)."""

    def __init__(self, model: USOTNet, p: TrackerConfig, im_h: int,
                 im_w: int, max_frames: int = 4096, chunk: int = 64,
                 fused_head: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.p = p
        self.im_h, self.im_w = im_h, im_w
        self.max_frames = max_frames
        self.chunk = chunk
        self.fused = fold_inference_head(model.connect_model) \
            if fused_head else None
        self._consts = make_consts(p, self.device)

    # ---- one frame step, B lanes ----

    def _search(self, carry: EngineState, frames, avg_b, im_hw_b):
        """Crop and backbone of one frame step. frames: (B, H, W, 3)
        uint8 on the device; avg_b (B, 3); im_hw_b (B, 2) [h, w] valid
        region of each lane's canvas. Returns (scale_z (B,), xf)."""
        p = self.p
        frame_h, frame_w = frames.shape[1], frames.shape[2]
        sz = carry.sz                                        # (B, 2)
        wc_z = sz[:, 0] + p.context_amount * (sz[:, 0] + sz[:, 1])
        hc_z = sz[:, 1] + p.context_amount * (sz[:, 0] + sz[:, 1])
        s_z = torch.sqrt(wc_z * hc_z)
        scale_z = p.exemplar_size / s_z
        d_search = (p.instance_size - p.exemplar_size) / 2
        s_x = torch.round(s_z + 2 * d_search / scale_z)
        vh = torch.clamp(im_hw_b[:, 0], max=float(frame_h))
        vw = torch.clamp(im_hw_b[:, 1], max=float(frame_w))
        x_crop = subwindow_gather(frames, carry.pos[:, 0], carry.pos[:, 1],
                                  s_x, avg_b, p.instance_size, valid_h=vh,
                                  valid_w=vw)

        dtype = next(self.model.parameters()).dtype
        return scale_z, self.model.search_features(x_crop.to(dtype))

    def _heads(self, carry: EngineState, xf):
        """Heads of one frame step on the search features `xf` against
        the template and the queue the carry's ring yields. Returns
        (cls, bbox, cls_mem)."""
        p = self.p
        model = self.model
        dtype = next(model.parameters()).dtype
        picks = _queue_picks(carry.mem_conf, carry.mem_idx, carry.mem_len,
                             p.mem_queue_size)               # (B, Nq - 2)
        queue_enc = tuple(
            torch.cat([init, _gather_slots(ring, picks)], dim=1).to(dtype)
            for init, ring in zip(carry.init_enc, carry.mem_enc))
        zf_enc = tuple(tuple(t[:, 0].to(dtype) for t in side)
                       for side in carry.zf_enc)
        if self.fused is not None:
            cls, bbox, cls_mem = model.track_memory_encoded_fused(
                xf, zf_enc, queue_enc, self.fused)
        else:
            cls, bbox, cls_mem = model.track_memory_encoded_batched(
                xf, zf_enc, queue_enc)
        return cls, bbox, cls_mem

    def _frame_step_batched(self, carry: EngineState, frames, is_valid,
                            avg_b, im_hw_b):
        """Natively batched frame step (counterpart of
        `usot_tpu/tracker/engine.py:680-768`). is_valid: (B,) bool.
        Returns (new carry, (pos (B, 2), sz (B, 2), score (B,)))."""
        p = self.p
        model = self.model
        scale_z, xf = self._search(carry, frames, avg_b, im_hw_b)
        cls, bbox, cls_mem = self._heads(carry, xf)
        new_pos, new_sz, best_score, pool_bbox = _postprocess_traced(
            p, self._consts, carry.pos, carry.sz, scale_z, cls, bbox,
            cls_mem)
        feat = model.pool_memory_feature(xf, pool_bbox)      # (B, 7, 7, C)
        feat_enc = tuple(f[:, None] for f in
                         model.encode_memory_kernels(feat))  # (B,1,h,w,C)
        mem_enc, mem_conf, mem_idx, mem_len = _memory_write_multi_batched(
            carry.mem_enc, carry.mem_conf, carry.mem_idx, carry.mem_len,
            feat_enc, best_score, is_valid)

        im_h, im_w = im_hw_b[:, 0], im_hw_b[:, 1]
        new_pos = torch.stack(
            [torch.minimum(torch.clamp(new_pos[:, 0], min=0.0), im_w),
             torch.minimum(torch.clamp(new_pos[:, 1], min=0.0), im_h)], -1)
        new_sz = torch.stack(
            [torch.minimum(torch.clamp(new_sz[:, 0], min=10.0), im_w),
             torch.minimum(torch.clamp(new_sz[:, 1], min=10.0), im_h)], -1)
        new_carry = EngineState(new_pos, new_sz, carry.zf_enc,
                                carry.init_enc, mem_enc, mem_conf, mem_idx,
                                mem_len)
        return new_carry, (new_pos, new_sz, best_score)

    @torch.inference_mode()
    def _chunk(self, carry: EngineState, frames, valid, avg_b, im_hw_b):
        """One chunk on the device: frames (T, B, H, W, 3) uint8, valid
        (T, B) bool, both on the device. A Python loop over T that makes
        no host synchronisation. Returns (carry, (pos (T, B, 2),
        sz (T, B, 2), score (T, B))) with the outputs on the device."""
        outs = []
        for t in range(frames.shape[0]):
            new, out = self._frame_step_batched(carry, frames[t], valid[t],
                                                avg_b, im_hw_b)
            carry = _freeze_invalid(new, carry, valid[t])
            outs.append(out)
        return carry, tuple(torch.stack(o) for o in zip(*outs))

    # ---- host API ----

    def _init_host(self, im, target_pos, target_sz):
        """Host-side init work: the template crop and the two memory
        bootstrap crops with their pool labels (ref:
        usot_tracker.py:22-131). No device work."""
        p = self.p
        target_pos = np.asarray(target_pos, np.float64)
        target_sz = np.asarray(target_sz, np.float64)
        avg_chans = np.mean(im, axis=(0, 1))

        wc_z = target_sz[0] + p.context_amount * target_sz.sum()
        hc_z = target_sz[1] + p.context_amount * target_sz.sum()
        s_z = round(np.sqrt(wc_z * hc_z))

        tf_axis = feature_axis(p.tf_size, p.total_stride, p.exemplar_size)
        z_crop, info = get_subwindow(im, target_pos, p.exemplar_size, s_z,
                                     avg_chans, target_sz, need_bbox=True)
        tb = np.clip(np.asarray(info["template_bbox"], np.float32),
                     tf_axis[0], tf_axis[-1])
        tb = (tb - tf_axis[0]) * (2 * (p.tf_size // 2)) / (tf_axis[-1]
                                                           - tf_axis[0])

        s_z_f = np.sqrt(wc_z * hc_z)
        scale_z = p.exemplar_size / s_z_f
        s_x = s_z_f + 2 * ((p.instance_size - p.exemplar_size) / 2) / scale_z
        x_crop, info = get_subwindow(im, target_pos, p.instance_size,
                                     python2round(s_x), avg_chans,
                                     target_sz, need_bbox=True)
        sf_axis = feature_axis(p.sf_size, p.total_stride, p.instance_size)

        def pool_label(bbox):
            gap = (sf_axis[-1] - sf_axis[0]) / (2 * (p.sf_size // 2))
            b = np.clip(np.asarray(bbox, np.float32), sf_axis[0] - gap,
                        sf_axis[-1] + gap)
            return (b - sf_axis[0]) / gap

        x_aug, bbox_aug = _flip_lr(np.asarray(x_crop), info["template_bbox"])
        bbox_aug = [_clip_number(bbox_aug[0], _max=x_aug.shape[1]),  # x vs W
                    _clip_number(bbox_aug[1], _max=x_aug.shape[0]),  # y vs H
                    _clip_number(bbox_aug[2], _max=x_aug.shape[1]),
                    _clip_number(bbox_aug[3], _max=x_aug.shape[0])]
        return dict(
            pos=target_pos, sz=target_sz, avg=avg_chans,
            z_crop=np.asarray(z_crop, np.float32), tb=tb,
            x_crop=np.asarray(x_crop, np.float32),
            sb0=pool_label(info["template_bbox"]),
            x_aug=x_aug.astype(np.float32), sb1=pool_label(bbox_aug))

    def _f32(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @torch.inference_mode()
    def init_state(self, im, target_pos, target_sz, runner) -> EngineState:
        """Per-video init: template + memory bootstrap (2 host crops, as
        the reference init; ref: usot_tracker.py:22-131). `runner` is a
        `ModelRunner` on this engine's device."""
        h = self._init_host(im, target_pos, target_sz)
        self.avg_chans = h["avg"]
        self._avg_b = self._f32(h["avg"])[None]
        self._im_hw_b = self._f32([self.im_h, self.im_w])[None]
        zf_enc = runner.encode_template(runner.template(h["z_crop"],
                                                        h["tb"]))
        feat0 = runner.extract_memory_feature(x_hwc=h["x_crop"],
                                              search_bbox=h["sb0"])
        feat1 = runner.extract_memory_feature(x_hwc=h["x_aug"],
                                              search_bbox=h["sb1"])
        feat_enc = runner.encode_memory_kernels(torch.cat([feat0, feat1]))
        return self._assemble_state(h, zf_enc, feat_enc)

    def _assemble_state(self, h, zf_enc, feat_enc) -> EngineState:
        """The initial carry on the device. feat_enc: 3-tuple of
        (2, h_i, w_i, C), the encoded [bootstrap, flipped bootstrap]
        anchors; slot 0 of each ring starts with the unflipped bootstrap
        (ref: usot_tracker.py:141-142), the +1 slot is the scratch slot
        for invalid-frame writes."""
        mem_enc = []
        for f in feat_enc:
            ring = torch.zeros((self.max_frames + 1,) + tuple(f.shape[1:]),
                               dtype=f.dtype, device=self.device)
            ring[0] = f[0]
            mem_enc.append(ring)
        mem_conf = torch.zeros(self.max_frames, device=self.device)
        mem_conf[0] = 0.9
        mem_idx = torch.full((self.max_frames,), -1, dtype=torch.int32,
                             device=self.device)
        mem_idx[0] = 0
        return EngineState(
            pos=self._f32(h["pos"]), sz=self._f32(h["sz"]),
            zf_enc=tuple(tuple(side) for side in zf_enc),
            init_enc=tuple(feat_enc), mem_enc=tuple(mem_enc),
            mem_conf=mem_conf, mem_idx=mem_idx,
            mem_len=torch.ones((), dtype=torch.int32, device=self.device))

    def run_chunk(self, state: EngineState, frames, valid, im_hw_b=None):
        """One chunk on (T, H, W, 3) uint8 frames and (T,) validity, both
        already on the device. Makes no host synchronisation. Returns
        (state, (pos (T, 2), sz (T, 2), score (T,))) on the device."""
        carry, outs = self._chunk(
            _lift(state), frames[:, None], valid[:, None], self._avg_b,
            self._im_hw_b if im_hw_b is None else im_hw_b)
        return _drop(carry), tuple(o[:, 0] for o in outs)

    def iter_chunks(self, state: EngineState, frames_u8: np.ndarray,
                    im_hw=None):
        """Stream-track (N, H, W, 3) uint8 frames chunk by chunk. Yields
        (frame_offset, n_valid, state, outs) per chunk with `outs` still
        on the device; a caller that finds a failure in a chunk stops
        iterating. im_hw: the video's true (h, w) when its frames are
        padded onto a larger canvas."""
        im_hw_b = None if im_hw is None else self._f32(im_hw)[None]
        for i in range(0, len(frames_u8), self.chunk):
            block = frames_u8[i:i + self.chunk]
            nb = len(block)
            if nb < self.chunk:
                pad = np.repeat(block[-1:], self.chunk - nb, axis=0)
                block = np.concatenate([block, pad], axis=0)
            frames = torch.from_numpy(np.ascontiguousarray(block)) \
                .to(self.device)
            valid = torch.from_numpy(np.arange(self.chunk) < nb) \
                .to(self.device)
            state, outs = self.run_chunk(state, frames, valid, im_hw_b)
            yield i, nb, state, outs

    def track_frames(self, state: EngineState, frames_u8: np.ndarray,
                     im_hw=None):
        """Track (N, H, W, 3) uint8 frames. Returns (state, positions
        (N, 2), sizes (N, 2), scores (N,)) as numpy; one copy to the host
        per chunk, after the last chunk is queued."""
        pending = []
        for _, nb, state, outs in self.iter_chunks(state, frames_u8, im_hw):
            pending.append((nb, outs))
        pos, sz, score = (np.concatenate([o[k][:nb].cpu().numpy()
                                          for nb, o in pending])
                          for k in range(3))
        return state, pos, sz, score


class BatchScanEngine(ScanEngine):
    """Tracks B videos in lockstep on one (canvas_h, canvas_w) uint8
    canvas; each lane's true (h, w) rides in `_im_hw_b` for crop validity
    and clamping. The step is `_frame_step_batched`: the network sees real
    (B, ...) batches (JAX's `impl="native"`)."""

    def __init__(self, model: USOTNet, p: TrackerConfig, canvas_h: int,
                 canvas_w: int, batch: int, max_frames: int = 2048,
                 chunk: int = 32, fused_head: bool = False, device=None):
        self.batch = batch
        super().__init__(model, p, im_h=canvas_h, im_w=canvas_w,
                         max_frames=max_frames, chunk=chunk,
                         fused_head=fused_head, device=device)

    @torch.inference_mode()
    def init_batch(self, videos, runner) -> EngineState:
        """videos: list of (first_frame, target_pos, target_sz). Host
        crops per video, then the model passes batched across the group:
        the template for B videos, the memory bootstrap for 2B crops."""
        hosts = [self._init_host(im, pos, sz) for im, pos, sz in videos]
        hws = [[im.shape[0], im.shape[1]] for im, _, _ in videos]
        b = len(hosts)
        if b != self.batch:
            raise ValueError(f"{b} videos for a batch of {self.batch}")

        z = np.stack([h["z_crop"] for h in hosts])            # (B, T, T, 3)
        tb = np.stack([h["tb"] for h in hosts])               # (B, 4)
        zf_enc = runner.encode_template(runner.template_batch(z, tb))
        xs = np.stack([h[k] for h in hosts for k in ("x_crop", "x_aug")])
        sbs = np.stack([h[k] for h in hosts for k in ("sb0", "sb1")])
        feat_enc = runner.encode_memory_kernels(
            runner.extract_memory_feature_batch(xs, sbs))   # 3x (2B,h,w,C)

        mem_enc = []
        for f in feat_enc:
            ring = torch.zeros((b, self.max_frames + 1) + tuple(f.shape[1:]),
                               dtype=f.dtype, device=self.device)
            ring[:, 0] = f[0::2]
            mem_enc.append(ring)
        init_enc = tuple(torch.stack([f[0::2], f[1::2]], dim=1)
                         for f in feat_enc)                  # (B,2,h,w,C)
        mem_conf = torch.zeros((b, self.max_frames), device=self.device)
        mem_conf[:, 0] = 0.9
        mem_idx = torch.full((b, self.max_frames), -1, dtype=torch.int32,
                             device=self.device)
        mem_idx[:, 0] = 0
        self._avg_b = self._f32(np.stack([h["avg"] for h in hosts]))
        self._im_hw_b = self._f32(hws)
        return EngineState(
            pos=self._f32(np.stack([h["pos"] for h in hosts])),
            sz=self._f32(np.stack([h["sz"] for h in hosts])),
            # (B, 1, h, w, C): the per-video model batch dim of the
            # single-video layout
            zf_enc=tuple(tuple(t[:, None] for t in side) for side in zf_enc),
            init_enc=init_enc, mem_enc=tuple(mem_enc),
            mem_conf=mem_conf, mem_idx=mem_idx,
            mem_len=torch.ones(b, dtype=torch.int32, device=self.device))

    def _prep_chunks(self, frames_u8: np.ndarray, n_valid: np.ndarray):
        """Host-side chunking of (B, N, H, W, 3) into (T, B, H, W, 3)
        uint8 blocks and (T, B) validity masks. Yields (nb, block,
        valid) as numpy."""
        b, n = frames_u8.shape[:2]
        if b != self.batch:
            raise ValueError(f"{b} lanes for a batch of {self.batch}")
        n_valid = np.asarray(n_valid)
        for i in range(0, n, self.chunk):
            block = frames_u8[:, i:i + self.chunk]
            nb = block.shape[1]
            if nb < self.chunk:
                pad = np.repeat(block[:, -1:], self.chunk - nb, axis=1)
                block = np.concatenate([block, pad], axis=1)
            t_idx = np.arange(self.chunk)[:, None] + i
            valid = t_idx < n_valid[None, :]
            yield nb, np.ascontiguousarray(np.swapaxes(block, 0, 1)), valid

    def _upload(self, block, valid):
        return (torch.from_numpy(block).to(self.device),
                torch.from_numpy(np.asarray(valid, bool)).to(self.device))

    def run_chunk(self, state: EngineState, block, valid):
        """One chunk on (T, B, H, W, 3) uint8 frames and (T, B) validity,
        both already on the device. Makes no host synchronisation.
        Returns (state, (pos, sz, score)) with the outputs on the
        device."""
        return self._chunk(state, block, valid, self._avg_b, self._im_hw_b)

    @staticmethod
    def _collate(pending):
        """[(nb, (pos (T,B,2), sz, score)), ...] -> numpy (pos (B,N,2),
        sz (B,N,2), score (B,N)): the one copy to the host per call."""
        pos, sz, score = (np.concatenate([o[k][:nb].cpu().numpy()
                                          for nb, o in pending])
                          for k in range(3))
        return pos.transpose(1, 0, 2), sz.transpose(1, 0, 2), score.T

    def track_batch(self, state: EngineState, frames_u8: np.ndarray,
                    n_valid: np.ndarray):
        """frames_u8: (B, N, H, W, 3) canvas frames; n_valid: (B,) true
        frame counts. Returns (state, pos (B, N, 2), sz (B, N, 2),
        score (B, N)); entries past a lane's n_valid are padding."""
        pending = []
        for nb, block, valid in self._prep_chunks(frames_u8, n_valid):
            state, outs = self.run_chunk(state, *self._upload(block, valid))
            pending.append((nb, outs))
        return (state,) + self._collate(pending)

    def stage_frames(self, frames_u8: np.ndarray, n_valid: np.ndarray):
        """Upload every chunk of a (B, N, H, W, 3) frame tensor to the
        device first; returns a list for `track_staged`, so a benchmark
        times tracking and not the host link."""
        return [(nb,) + self._upload(block, valid)
                for nb, block, valid in self._prep_chunks(frames_u8,
                                                          n_valid)]

    def track_staged(self, state: EngineState, staged):
        """Track pre-staged chunks (see stage_frames). Same returns as
        track_batch."""
        pending = []
        for nb, block, valid in staged:
            state, outs = self.run_chunk(state, block, valid)
            pending.append((nb, outs))
        return (state,) + self._collate(pending)


def synthetic_video(n_frames, h=480, w=640, box=60, seed=0):
    """`bench.py`'s synthetic video (the port's own copy of the recipe):
    a coloured square on a fixed noise frame, its centre on a triangle
    wave of period 64 frames (1.5 px/frame in x, 0.7 in y), so repeated
    passes over the same frames keep tracking a pose the carry still
    sees. Returns a list of (h, w, 3) uint8 frames; frame f's centre is
    (200 + int(1.5 * tri(f)), 240 + int(0.7 * tri(f)))."""
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)

    def tri(f, half_p=32):
        return half_p - abs(f % (2 * half_p) - half_p)

    frames = []
    for f in range(n_frames):
        im = base.copy()
        cx = 200 + int(1.5 * tri(f))
        cy = 240 + int(0.7 * tri(f))
        im[cy - box // 2:cy + box // 2, cx - box // 2:cx + box // 2] = \
            [180, 160, 90]
        frames.append(im)
    return frames
