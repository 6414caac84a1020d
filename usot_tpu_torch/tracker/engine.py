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

`BatchScanEngine` also carries the lane surgery the benchmark protocols
of `tracker/lockstep.py` stand on (`run_chunk(donate=False)`,
`make_lane_state(s)`, `splice_lane(s)`) and ROI streaming with its
exactness replay (`track_batch_roi`; `engine.py:898-1443`), and shards
its lanes over a device mesh (`mesh=`, `engine.py:628-666`).

The network runs in the model's compute dtype (`USOTNet.dtype`,
float32 or bfloat16); the template, the init anchors and the memory
rings are carried in it; positions, sizes, confidences and the
postprocess stay float32 (`engine.py:340-365`).

Not carried over: `impl="vmap"`, `unroll` and `carry_dtype` (no caller
passes a carry dtype other than the compute dtype).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from usot_tpu_torch.core.crop import (crop_windows, get_subwindow,
                                      subwindow_gather, subwindow_geometry)
from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.core.geometry import (feature_axis, python2round,
                                          score_grid)
from usot_tpu_torch.models.head import fold_inference_head
from usot_tpu_torch.models.usot import USOTNet
from usot_tpu_torch.parallel.mesh import replicate_tree, shard_batch
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.postprocess import hanning_window
from usot_tpu_torch.tracker.tracker import _clip_number
from usot_tpu_torch.utils.profiling import span

# px of slack around each crop window the ROI exactness check demands
_ROI_MARGIN = 2.0


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


class MeshState(NamedTuple):
    """The carry of a `BatchScanEngine` with a mesh: one `EngineState` per
    shard, each over its contiguous block of lanes, on its device. `pos`
    and `sz` read the global (B, 2) on the first shard's device
    (`BatchScanEngine.gather_state` gives the whole carry)."""
    shards: tuple

    @property
    def pos(self):
        return _cat([s.pos for s in self.shards])

    @property
    def sz(self):
        return _cat([s.sz for s in self.shards])


def _cat(parts):
    """Concatenate lane blocks (tensors, or equal trees of tuples of
    them) along dim 0, on the first block's device."""
    if isinstance(parts[0], tuple):
        return tuple(_cat(list(z)) for z in zip(*parts))
    return torch.cat([t.to(parts[0].device) for t in parts])


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
    _scatter_slots(rings, feats, ring_idx)
    mem_conf = mem_conf.scatter(1, write_idx[:, None], score[:, None])
    mem_idx = mem_idx.scatter(1, write_idx[:, None], mem_len[:, None])
    return rings, mem_conf, mem_idx, mem_len + 1


def _scatter_slots(rings, feats, ring_idx):
    """Write lane b's feats[i][b, 0] into slot ring_idx[b] of rings[i]
    (B, S', h, w, C), in place: one `index_copy_` per ring over the
    lanes' flattened slots."""
    b = ring_idx.shape[0]
    lanes = torch.arange(b, device=ring_idx.device)
    for r, f in zip(rings, feats):
        flat = r.view((b * r.shape[1],) + tuple(r.shape[2:]))
        flat.index_copy_(0, lanes * r.shape[1] + ring_idx,
                         f[:, 0].to(r.dtype))


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


def _penalized_scores(p, c, sz, scale_z, cls, bbox, cls_mem):
    """The score map `_postprocess_traced` takes its argmax of, in f32:
    (pscore (B, S, S), cls_score, penalty, (pred_x1, pred_y1, pred_x2,
    pred_y2)), the last four (B, S, S) too."""
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
    return pscore, cls_score, penalty, (pred_x1, pred_y1, pred_x2, pred_y2)


def best_cells(p, c, sz, scale_z, cls, bbox, cls_mem):
    """(B,) the flat score-map cell each lane's step picks."""
    pscore = _penalized_scores(p, c, sz, scale_z, cls, bbox, cls_mem)[0]
    return pscore.reshape(pscore.shape[0], -1).argmax(dim=1)


def _postprocess_traced(p, c, pos, sz, scale_z, cls, bbox, cls_mem):
    """On-device postprocess of a batch of videos, in f32: penalties,
    cosine window, argmax, size EMA, pool bbox (counterpart of
    `usot_tpu/tracker/engine.py:260-332`, which JAX vmaps over videos).

    pos, sz: (B, 2); scale_z: (B,); cls/bbox/cls_mem: (B, S, S, {1,4,1})
    raw head outputs; c: `make_consts`. Returns (new_pos (B, 2),
    new_sz (B, 2), best_score (B,), pool_bbox (B, 4))."""
    b = pos.shape[0]
    pscore, cls_score, penalty, (pred_x1, pred_y1, pred_x2, pred_y2) = \
        _penalized_scores(p, c, sz, scale_z, cls, bbox, cls_mem)
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

def folded_head(model: USOTNet) -> dict:
    """`fold_inference_head`'s weights of `model`'s head, folded in
    float32 and cast once to its compute dtype: the `fused` argument of
    `USOTNet.track_memory_encoded_fused`."""
    dtype = model.dtype
    folded = fold_inference_head(model.connect_model)
    return {"encoders": [(w.to(dtype), b.to(dtype))
                         for w, b in folded["encoders"]],
            "conf_value": tuple(t.to(dtype) for t in folded["conf_value"])}


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
    heads on folded BN weights (`fold_inference_head`, folded in float32
    and cast once to the compute dtype here)."""

    def __init__(self, model: USOTNet, p: TrackerConfig, im_h: int,
                 im_w: int, max_frames: int = 4096, chunk: int = 64,
                 fused_head: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().cast_weights()
        self.dtype = model.dtype
        self.p = p
        self.im_h, self.im_w = im_h, im_w
        self.max_frames = max_frames
        self.chunk = chunk
        self.fused = folded_head(model) if fused_head else None
        self._consts = make_consts(p, self.device)
        # the frame buffer's image-coordinate origin: (0, 0) for full
        # frames (ROI streaming passes its windows' origins)
        self._origin0 = torch.zeros((1, 2), device=self.device)
        # `BatchScanEngine.init_batch` calls so far: the round ordinal
        # the spans carry
        self.rounds = 0
        # lanes whose init crops ran on the device (`init_batch`,
        # `make_lane_states`); the single-video inits crop on the host
        self.init_lanes_device = 0

    # ---- one frame step, B lanes ----

    def _search(self, carry: EngineState, frames, avg_b, im_hw_b, origin_b):
        """Crop and backbone of one frame step. frames: (B, H, W, 3)
        uint8 on the device; avg_b (B, 3); im_hw_b (B, 2) [h, w] valid
        region of each lane's image; origin_b (B, 2) [x, y] image
        coordinates of each lane's frame buffer's top-left (zero for full
        frames, the window's origin for an ROI). Returns
        (scale_z (B,), xf)."""
        p = self.p
        frame_h, frame_w = frames.shape[1], frames.shape[2]
        sz = carry.sz                                        # (B, 2)
        wc_z = sz[:, 0] + p.context_amount * (sz[:, 0] + sz[:, 1])
        hc_z = sz[:, 1] + p.context_amount * (sz[:, 0] + sz[:, 1])
        s_z = torch.sqrt(wc_z * hc_z)
        scale_z = p.exemplar_size / s_z
        d_search = (p.instance_size - p.exemplar_size) / 2
        s_x = torch.round(s_z + 2 * d_search / scale_z)
        # valid region of the buffer: the image minus the origin,
        # clipped to the buffer (`usot_tpu/tracker/engine.py:708-712`)
        vh = torch.clamp(im_hw_b[:, 0] - origin_b[:, 1], max=float(frame_h))
        vw = torch.clamp(im_hw_b[:, 1] - origin_b[:, 0], max=float(frame_w))
        x_crop = subwindow_gather(frames, carry.pos[:, 0], carry.pos[:, 1],
                                  s_x, avg_b, p.instance_size, valid_h=vh,
                                  valid_w=vw, origin=origin_b)

        return scale_z, self.model.search_features(x_crop.to(self.dtype))

    def _heads(self, carry: EngineState, xf):
        """Heads of one frame step on the search features `xf` against
        the template and the queue the carry's ring yields. Returns
        (cls, bbox, cls_mem)."""
        p = self.p
        model = self.model
        dtype = self.dtype
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
                            avg_b, im_hw_b, origin_b):
        """Natively batched frame step (counterpart of
        `usot_tpu/tracker/engine.py:680-768`). is_valid: (B,) bool.
        Returns (new carry, (pos (B, 2), sz (B, 2), score (B,)))."""
        p = self.p
        model = self.model
        with span("engine.search"):
            scale_z, xf = self._search(carry, frames, avg_b, im_hw_b,
                                       origin_b)
        with span("engine.heads"):
            cls, bbox, cls_mem = self._heads(carry, xf)
        with span("engine.post"):
            new_pos, new_sz, best_score, pool_bbox = _postprocess_traced(
                p, self._consts, carry.pos, carry.sz, scale_z, cls, bbox,
                cls_mem)
            im_h, im_w = im_hw_b[:, 0], im_hw_b[:, 1]
            new_pos = torch.stack(
                [torch.minimum(torch.clamp(new_pos[:, 0], min=0.0), im_w),
                 torch.minimum(torch.clamp(new_pos[:, 1], min=0.0), im_h)],
                -1)
            new_sz = torch.stack(
                [torch.minimum(torch.clamp(new_sz[:, 0], min=10.0), im_w),
                 torch.minimum(torch.clamp(new_sz[:, 1], min=10.0), im_h)],
                -1)
        with span("engine.memory"):
            feat = model.pool_memory_feature(xf, pool_bbox)  # (B, 7, 7, C)
            feat_enc = tuple(f[:, None] for f in
                             model.encode_memory_kernels(feat))
            mem_enc, mem_conf, mem_idx, mem_len = \
                _memory_write_multi_batched(
                    carry.mem_enc, carry.mem_conf, carry.mem_idx,
                    carry.mem_len, feat_enc, best_score, is_valid)
        new_carry = EngineState(new_pos, new_sz, carry.zf_enc,
                                carry.init_enc, mem_enc, mem_conf, mem_idx,
                                mem_len)
        return new_carry, (new_pos, new_sz, best_score)

    @torch.inference_mode()
    def _chunk(self, carry: EngineState, frames, valid, avg_b, im_hw_b,
               origin_b):
        """One chunk on the device: frames (T, B, H, W, 3) uint8, valid
        (T, B) bool, both on the device; origin_b (B, 2) as `_search`. A
        Python loop over T that makes no host synchronisation. Returns
        (carry, (pos (T, B, 2), sz (T, B, 2), score (T, B))) with the
        outputs on the device."""
        outs = []
        for t in range(frames.shape[0]):
            with span("engine.step", self.rounds):
                new, out = self._frame_step_batched(
                    carry, frames[t], valid[t], avg_b, im_hw_b, origin_b)
                carry = _freeze_invalid(new, carry, valid[t])
            outs.append(out)
        return carry, tuple(torch.stack(o) for o in zip(*outs))

    # ---- host API ----

    def _init_geometry(self, im_shape, target_pos, target_sz):
        """The scalar part of a lane's init, on the host in float64 with
        Python's rounding (ref: usot_tracker.py:22-131): the sides of the
        template and search windows (`s_z`, `s_x`) and their windows
        (`z_win`, `x_win`, from `subwindow_geometry`), the template box
        `tb`, and the pool labels of the bootstrap crop (`sb0`) and of
        its flip (`sb1`)."""
        p = self.p
        target_pos = np.asarray(target_pos, np.float64)
        target_sz = np.asarray(target_sz, np.float64)

        wc_z = target_sz[0] + p.context_amount * target_sz.sum()
        hc_z = target_sz[1] + p.context_amount * target_sz.sum()
        s_z = round(np.sqrt(wc_z * hc_z))

        tf_axis = feature_axis(p.tf_size, p.total_stride, p.exemplar_size)
        info, z_win = subwindow_geometry(im_shape, target_pos,
                                         p.exemplar_size, s_z, target_sz,
                                         need_bbox=True)
        tb = np.clip(np.asarray(info["template_bbox"], np.float32),
                     tf_axis[0], tf_axis[-1])
        tb = (tb - tf_axis[0]) * (2 * (p.tf_size // 2)) / (tf_axis[-1]
                                                           - tf_axis[0])

        s_z_f = np.sqrt(wc_z * hc_z)
        scale_z = p.exemplar_size / s_z_f
        s_x = s_z_f + 2 * ((p.instance_size - p.exemplar_size) / 2) / scale_z
        s_x = python2round(s_x)
        info, x_win = subwindow_geometry(im_shape, target_pos,
                                         p.instance_size, s_x, target_sz,
                                         need_bbox=True)
        sf_axis = feature_axis(p.sf_size, p.total_stride, p.instance_size)

        def pool_label(bbox):
            gap = (sf_axis[-1] - sf_axis[0]) / (2 * (p.sf_size // 2))
            b = np.clip(np.asarray(bbox, np.float32), sf_axis[0] - gap,
                        sf_axis[-1] + gap)
            return (b - sf_axis[0]) / gap

        # the box in the left-right flip of the (S, S) search crop
        s = p.instance_size
        x1, y1, x2, y2 = info["template_bbox"]
        bbox_aug = [_clip_number(v, _max=s) for v in (s - x2, y1, s - x1, y2)]
        return dict(pos=target_pos, sz=target_sz, s_z=s_z, s_x=s_x,
                    z_win=z_win, x_win=x_win, tb=tb,
                    sb0=pool_label(info["template_bbox"]),
                    sb1=pool_label(bbox_aug))

    def _init_host(self, im, target_pos, target_sz):
        """Host-side init work: the template crop and the two memory
        bootstrap crops with their pool labels (ref:
        usot_tracker.py:22-131). No device work."""
        p = self.p
        g = self._init_geometry(im.shape, target_pos, target_sz)
        avg_chans = np.mean(im, axis=(0, 1))
        z_crop, _ = get_subwindow(im, g["pos"], p.exemplar_size, g["s_z"],
                                  avg_chans)
        x_crop, _ = get_subwindow(im, g["pos"], p.instance_size, g["s_x"],
                                  avg_chans)
        x_crop = np.asarray(x_crop, np.float32)
        return dict(
            pos=g["pos"], sz=g["sz"], avg=avg_chans,
            z_crop=np.asarray(z_crop, np.float32), tb=g["tb"],
            x_crop=x_crop, sb0=g["sb0"],
            x_aug=np.ascontiguousarray(x_crop[:, ::-1]), sb1=g["sb1"])

    def _f32(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
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
            self._im_hw_b if im_hw_b is None else im_hw_b, self._origin0)
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
    (B, ...) batches (JAX's `impl="native"`).

    mesh: a `parallel.mesh.Mesh` of n devices (None, or n = 1: one
    device). Tracking is data-parallel over videos with no collective, as
    under JAX's mesh: the B lanes split into n contiguous blocks of B/n,
    each tracked by an engine of its own (`_shards`) on its device with
    that device's model replica (`replicate_tree`; devices that repeat
    share one). `batch % n` must be 0. The carry is a `MeshState`; every
    public method takes and returns global tensors in lane order on
    `device` (the mesh's first): a chunk's frames and validity are split
    per shard, every shard's chunk is dispatched before any is waited on,
    and the outputs are gathered on `device` with no host sync. The
    template init runs once for all lanes on `device`, as JAX runs it on
    the runner, and is then split; ROI decisions stay one over all
    lanes."""

    def __init__(self, model: USOTNet, p: TrackerConfig, canvas_h: int,
                 canvas_w: int, batch: int, max_frames: int = 2048,
                 chunk: int = 32, fused_head: bool = False, device=None,
                 mesh=None):
        self.batch = batch
        if mesh is not None:
            if batch % mesh.size:
                raise ValueError(f"batch {batch} does not divide by the "
                                 f"mesh's {mesh.size} devices")
            device = mesh.devices[0]
        super().__init__(model, p, im_h=canvas_h, im_w=canvas_w,
                         max_frames=max_frames, chunk=chunk,
                         fused_head=fused_head, device=device)
        self._origin0 = torch.zeros((batch, 2), device=self.device)
        self.mesh = mesh
        self._shards = None
        if mesh is not None and mesh.size > 1:
            per = batch // mesh.size
            self._lanes = [(i * per, (i + 1) * per)
                           for i in range(mesh.size)]
            self._shards = [
                BatchScanEngine(replica, p, canvas_h, canvas_w, per,
                                max_frames=max_frames, chunk=chunk,
                                fused_head=fused_head, device=d)
                for replica, d in zip(replicate_tree(mesh, self.model),
                                      mesh.devices)]

    # ---- the mesh: global carry <-> per-shard carries ----

    def scatter_state(self, state: EngineState) -> MeshState:
        """A global carry (B lanes) as this engine's per-shard carry, each
        block on its shard's device (a view where it already is there;
        `shard_batch`). Sets each shard's avg and image-size rows from
        the engine's."""
        rows = shard_batch(self.mesh, (self._avg_b, self._im_hw_b))
        for sh, (avg, im_hw) in zip(self._shards, rows):
            sh._avg_b, sh._im_hw_b = avg, im_hw
        return MeshState(tuple(EngineState(*block) for block in
                               shard_batch(self.mesh, tuple(state))))

    def gather_state(self, state):
        """The global carry (an `EngineState` of B lanes on `device`) of a
        `MeshState`; an `EngineState` is returned as it is."""
        if not isinstance(state, MeshState):
            return state
        return EngineState(*_cat([tuple(s) for s in state.shards]))

    @torch.inference_mode()
    def init_batch(self, videos, runner) -> EngineState:
        """videos: list of (first_frame, target_pos, target_sz). The
        lanes' geometry on the host, their crops batched on the device
        (`_init_device`), then the model passes batched across the
        group: the template for B videos, the memory bootstrap for 2B
        crops."""
        self.rounds += 1
        for sh in self._shards or ():
            sh.rounds = self.rounds
        with span("engine.init_batch", self.rounds):
            with span("engine.init_host"):
                lanes = self._init_device(videos)
            return self._init_lanes(
                lanes, [[im.shape[0], im.shape[1]] for im, _, _ in videos],
                runner)

    def _upload_first(self, ims):
        """The lanes' first frames as one (B, H, W, 3) uint8 tensor on the
        device, lane b's image at its top-left and zeros beyond it (H, W:
        the largest image's), in one host-to-device copy. The staging
        buffer is pinned on a GPU; PyTorch's pinned-memory cache hands
        the same block back the next round once the copy out of it has
        ended, so the copy does not block the host."""
        shape = (len(ims), max(im.shape[0] for im in ims),
                 max(im.shape[1] for im in ims), 3)
        stage = torch.empty(shape, dtype=torch.uint8,
                            pin_memory=self.device.type == "cuda")
        for lane, im in zip(stage.numpy(), ims):
            h, w = im.shape[:2]
            lane[:h, :w] = im
            lane[h:] = 0
            lane[:h, w:] = 0
        return stage.to(self.device, non_blocking=True)

    def _init_device(self, videos) -> dict:
        """The host part of a batched init with its pixel work on the
        device: `_init_geometry` per lane on the host, the lanes' first
        frames up in one copy, and on the device, batched over the lanes,
        each frame's mean colour (np.mean's value: an exact integer sum
        over the pixel count, in float64) and the template and bootstrap
        crops (`crop_windows`; bitwise `_init_host`'s on the CPU) and the
        bootstrap's flip. Nothing waits for the device. Returns the
        stacked pieces `_init_lanes` takes."""
        p = self.p
        geo = [self._init_geometry(im.shape, pos, sz)
               for im, pos, sz in videos]
        hw = [im.shape[:2] for im, _, _ in videos]
        frames = self._upload_first([im for im, _, _ in videos])
        count = torch.tensor([h * w for h, w in hw], dtype=torch.float64)
        avg = frames.sum(dim=(1, 2), dtype=torch.int64).double() \
            / count.to(self.device, non_blocking=True)[:, None]
        fill = avg.to(torch.uint8).float()
        z = crop_windows(frames, hw, fill, [g["z_win"] for g in geo],
                         p.exemplar_size)
        x = crop_windows(frames, hw, fill, [g["x_win"] for g in geo],
                         p.instance_size)
        self.init_lanes_device += len(videos)
        return dict(
            pos=np.stack([g["pos"] for g in geo]),
            sz=np.stack([g["sz"] for g in geo]), avg=avg, z=z,
            tb=np.stack([g["tb"] for g in geo]),
            xs=torch.stack([x, x.flip(2)], dim=1).flatten(0, 1),
            sbs=np.stack([g[k] for g in geo for k in ("sb0", "sb1")]))

    @staticmethod
    def _encode(lanes, runner):
        """The batched model passes of an init: zf_enc, the template's
        (cls, reg) 3-tuples of (B, h, w, C), and feat_enc, the encoded
        [bootstrap, flip] anchors, a 3-tuple of (2B, h, w, C)."""
        zf_enc = runner.encode_template(runner.template_batch(lanes["z"],
                                                              lanes["tb"]))
        feat_enc = runner.encode_memory_kernels(
            runner.extract_memory_feature_batch(lanes["xs"], lanes["sbs"]))
        return zf_enc, feat_enc

    def _init_lanes(self, lanes, hws, runner) -> EngineState:
        """`init_batch`'s model passes and carry, from the lanes' stacked
        init pieces and their images' (h, w). lanes: pos, sz (B, 2) and
        avg (B, 3); the templates z (B, T, T, 3) with their boxes tb
        (B, 4); the bootstrap crops xs (2B, S, S, 3), each lane's crop
        then its flip, with their pool labels sbs (2B, 4). Crops are
        device tensors (`_init_device`) or numpy (`_init_host`'s,
        stacked)."""
        b = len(hws)
        if b != self.batch:
            raise ValueError(f"{b} videos for a batch of {self.batch}")
        zf_enc, feat_enc = self._encode(lanes, runner)

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
        self._avg_b = self._f32(lanes["avg"])
        self._im_hw_b = self._f32(hws)
        # Floor of `suggest_roi`: the crop-window span at init. A tracker
        # that loses its target collapses its size EMA, and an ROI sized
        # from the collapsed span replays as soon as the window has to
        # cover re-acquisition motion (`usot_tpu/tracker/engine.py:834-843`)
        x0, x1, _, _ = self._crop_window(lanes["pos"], lanes["sz"])
        self._init_span = float(np.max(x1 - x0))
        state = EngineState(
            pos=self._f32(lanes["pos"]), sz=self._f32(lanes["sz"]),
            # (B, 1, h, w, C): the per-video model batch dim of the
            # single-video layout
            zf_enc=tuple(tuple(t[:, None] for t in side) for side in zf_enc),
            init_enc=init_enc, mem_enc=tuple(mem_enc),
            mem_conf=mem_conf, mem_idx=mem_idx,
            mem_len=torch.ones(b, dtype=torch.int32, device=self.device))
        return state if self._shards is None else self.scatter_state(state)

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

    def run_chunk(self, state: EngineState, block, valid,
                  donate: bool = True):
        """One chunk on (T, B, H, W, 3) uint8 frames and (T, B) validity,
        both already on the device. Makes no host synchronisation.
        Returns (state, (pos, sz, score)) with the outputs on the device.

        donate=True writes the memory rings of `state` in place: `state`
        is consumed. donate=False runs the chunk on copies of the rings,
        so `state` stays bitwise unchanged and shares no ring storage with
        the state returned; a protocol can splice into it and replay the
        chunk (the VOT restart path, `tracker/lockstep.py`). Without the
        copies a replay would be wrong once a lane's ring is full: its
        eviction overwrites a slot the old state still reads."""
        return self._run(state, block, valid, self._origin0, donate)

    @torch.inference_mode()
    def _run(self, state: EngineState, block, valid, origin_b, donate):
        if self._shards is not None:
            states, outs = [], []
            for sh, st, (a, b) in zip(self._shards, state.shards,
                                      self._lanes):
                st, o = sh._run(st, block[:, a:b].to(sh.device),
                                valid[:, a:b].to(sh.device),
                                origin_b[a:b].to(sh.device), donate)
                states.append(st)
                outs.append(o)
            return MeshState(tuple(states)), tuple(
                torch.cat([o[k].to(self.device) for o in outs], dim=1)
                for k in range(3))
        if not donate:
            state = state._replace(
                mem_enc=tuple(r.clone() for r in state.mem_enc))
        return self._chunk(state, block, valid, self._avg_b, self._im_hw_b,
                           origin_b)

    def _collate(self, pending):
        """[(nb, (pos (T,B,2), sz, score)), ...] -> numpy (pos (B,N,2),
        sz (B,N,2), score (B,N)): the one copy to the host per call."""
        with span("engine.collate", self.rounds):
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

    # ---- lane surgery (the VOT restart protocol and lane refill) ----

    @torch.inference_mode()
    def make_lane_state(self, im, target_pos, target_sz, runner) -> dict:
        """One video's init, as the pieces `splice_lane` writes into a
        lane. Runs the B=1 model passes of `ScanEngine.init_state`, so a
        restarted lane starts exactly where a fresh single-video engine
        would (the reference restart re-enters tracker.init the same way,
        ref: scripts/test_usot.py:98-103). zf_enc: (cls, reg) 3-tuples of
        (1, h, w, C); feat_enc: 3-tuple of (2, h, w, C), the encoded
        [bootstrap, flipped bootstrap]."""
        h = self._init_host(im, target_pos, target_sz)
        zf_enc = runner.encode_template(runner.template(h["z_crop"],
                                                        h["tb"]))
        feat0 = runner.extract_memory_feature(x_hwc=h["x_crop"],
                                              search_bbox=h["sb0"])
        feat1 = runner.extract_memory_feature(x_hwc=h["x_aug"],
                                              search_bbox=h["sb1"])
        return dict(
            pos=np.asarray(h["pos"], np.float32),
            sz=np.asarray(h["sz"], np.float32),
            avg=np.asarray(h["avg"], np.float32),
            im_hw=np.asarray([im.shape[0], im.shape[1]], np.float32),
            zf_enc=zf_enc,
            feat_enc=runner.encode_memory_kernels(torch.cat([feat0, feat1])))

    @torch.inference_mode()
    def make_lane_states(self, videos, runner) -> dict:
        """`make_lane_state` for K <= B videos at once: the crops on the
        device (`_init_device`), then ONE set of batched model passes at
        the engine's batch (padded with copies of the first video), as
        `init_batch` runs them. For lane refill, where several lanes end
        at one chunk boundary. Numerics are the batched init's, not the
        B=1 passes' (VOT restarts keep `make_lane_state`). Returns the
        stacked pieces for `splice_lanes` (zf_enc (B, h, w, C), feat_enc
        (2B, h, w, C); avg on the device) with their count under "k"."""
        b, k = self.batch, len(videos)
        if not 1 <= k <= b:
            raise ValueError(f"{k} videos for a batch of {b}")
        lanes = self._init_device(videos)
        hws = [[im.shape[0], im.shape[1]] for im, _, _ in videos]
        hws += [hws[0]] * (b - k)

        def pad(a, rows=1):
            """a's lanes, then lane 0's `rows` rows for each missing lane."""
            cat = torch.cat if isinstance(a, torch.Tensor) else np.concatenate
            return cat([a] + [a[:rows]] * (b - k))

        lanes = {key: pad(a, 2 if key in ("xs", "sbs") else 1)
                 for key, a in lanes.items()}
        zf_enc, feat_enc = self._encode(lanes, runner)
        return dict(
            k=k, pos=lanes["pos"].astype(np.float32),
            sz=lanes["sz"].astype(np.float32), avg=lanes["avg"].float(),
            im_hw=np.asarray(hws, np.float32), zf_enc=zf_enc,
            feat_enc=feat_enc)

    def splice_lane(self, state: EngineState, lane: int,
                    lane_state: dict) -> EngineState:
        """Overwrite one lane of a batched carry with a fresh video's
        init (from `make_lane_state`) and set the engine's avg and
        image-size rows of that lane. See `splice_lanes`."""
        one = {key: lane_state[key][None]
               for key in ("pos", "sz", "avg", "im_hw")}
        return self._splice(state, [lane], {**lane_state, **one}, 1)

    def splice_lanes(self, state: EngineState, lanes,
                     lane_states: dict) -> EngineState:
        """Splice K fresh videos (from `make_lane_states`) into lanes
        `lanes` (K distinct ints) in one set of indexed writes, whatever
        K: no per-lane launches, no host synchronisation.

        The lanes' pos, sz, template and anchor encodings and ring
        bookkeeping (confidence 0.9 and logical index 0 at slot 0,
        length 1) come back as new tensors, and slot 0 of each ring is
        written IN PLACE with the unflipped bootstrap: splice into a
        state no other live state shares rings with (what `run_chunk`
        returns). The rest of the lane's ring stays stale and is
        unreachable: picks match slots by stored logical index. The other
        lanes are untouched."""
        k = lane_states["k"]
        if len(lanes) != k:
            raise ValueError(f"{len(lanes)} lanes for {k} lane states")
        return self._splice(state, lanes, lane_states, k)

    @torch.inference_mode()
    def _splice(self, state: EngineState, lanes, ls: dict,
                k: int) -> EngineState:
        if self._shards is not None:
            return self._splice_shards(state, lanes, ls)
        dev = self.device
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=dev)
        zero = torch.zeros_like(idx)

        def put(t, v):
            return t.index_put((idx,), v.to(dev, t.dtype))

        for ring, f in zip(state.mem_enc, ls["feat_enc"]):
            ring.index_put_((idx, zero), f[0:2 * k:2].to(ring.dtype))
        conf = torch.zeros((k, self.max_frames), device=dev)
        conf[:, 0] = 0.9
        slots = torch.full((k, self.max_frames), -1, dtype=torch.int32,
                           device=dev)
        slots[:, 0] = 0
        self._avg_b = put(self._avg_b, self._f32(ls["avg"][:k]))
        self._im_hw_b = put(self._im_hw_b, self._f32(ls["im_hw"][:k]))
        return EngineState(
            pos=put(state.pos, self._f32(ls["pos"][:k])),
            sz=put(state.sz, self._f32(ls["sz"][:k])),
            zf_enc=tuple(tuple(put(t, v[:k, None]) for t, v in zip(ts, vs))
                         for ts, vs in zip(state.zf_enc, ls["zf_enc"])),
            init_enc=tuple(
                put(t, torch.stack([f[0:2 * k:2], f[1:2 * k:2]], dim=1))
                for t, f in zip(state.init_enc, ls["feat_enc"])),
            mem_enc=state.mem_enc, mem_conf=put(state.mem_conf, conf),
            mem_idx=put(state.mem_idx, slots),
            mem_len=put(state.mem_len, torch.ones(k, dtype=torch.int32,
                                                  device=dev)))

    def _splice_shards(self, state: MeshState, lanes, ls: dict):
        """`_splice` on a mesh: each global lane maps to a shard and a
        local lane; each shard splices its own in one call."""
        per = self.batch // len(self._shards)
        shards = list(state.shards)
        for i, sh in enumerate(self._shards):
            js = [j for j, lane in enumerate(lanes) if lane // per == i]
            if not js:
                continue
            two = [r for j in js for r in (2 * j, 2 * j + 1)]
            sub = {key: ls[key][js] for key in ("pos", "sz", "avg", "im_hw")}
            sub["zf_enc"] = tuple(tuple(t[js].to(sh.device) for t in side)
                                  for side in ls["zf_enc"])
            sub["feat_enc"] = tuple(f[two].to(sh.device)
                                    for f in ls["feat_enc"])
            shards[i] = sh._splice(shards[i], [lanes[j] - i * per
                                               for j in js], sub, len(js))
        self._avg_b = _cat([sh._avg_b for sh in self._shards])
        self._im_hw_b = _cat([sh._im_hw_b for sh in self._shards])
        return MeshState(tuple(shards))

    # ---- ROI streaming ----

    def _crop_window(self, pos, sz):
        """Host mirror, in f64, of the device crop geometry: the pixel
        span [x0, x1], [y0, y1] the bilinear crop may tap for a frame
        stepped from (pos, sz), both (B, 2); +1 past the window for the
        second bilinear tap."""
        p = self.p
        wc = sz[:, 0] + p.context_amount * (sz[:, 0] + sz[:, 1])
        hc = sz[:, 1] + p.context_amount * (sz[:, 0] + sz[:, 1])
        s_z = np.sqrt(wc * hc)
        scale_z = p.exemplar_size / s_z
        d_search = (p.instance_size - p.exemplar_size) / 2
        s_x = np.round(s_z + 2 * d_search / scale_z)
        x0 = np.round(pos[:, 0] - (s_x + 1.0) / 2.0)
        y0 = np.round(pos[:, 1] - (s_x + 1.0) / 2.0)
        return x0, x0 + s_x, y0, y0 + s_x

    def suggest_roi(self, state: EngineState, chunk: int = None) -> int:
        """An ROI size for `track_batch_roi` with dispatches of `chunk`
        frames (default `self.chunk`), from the state: the widest lane's
        crop-window span (floored at its span at `init_batch`), grown by
        1.2 for the size EMA, plus room for the target to drift 2 px per
        frame over two chunks (the pipelined chunk's anchor is one chunk
        stale), rounded up to 32 px. A wrong guess costs replays, never
        exactness (`usot_tpu/tracker/engine.py:914-950` with its
        defaults)."""
        chunk = self.chunk if chunk is None else chunk
        x0, x1, _, _ = self._crop_window(
            state.pos.cpu().numpy().astype(np.float64),
            state.sz.cpu().numpy().astype(np.float64))
        s_x = max(float(np.max(x1 - x0)), getattr(self, "_init_span", 0.0))
        need = s_x * 1.2 + 1 + 2 * (_ROI_MARGIN + 2.0 * chunk * 2)
        return int(-(-need // 32) * 32)

    def warm_roi(self, state: EngineState, roi: int, chunk: int = None):
        """Run one all-invalid chunk of (roi x roi) frames through the
        path `track_batch_roi` takes, outside any timed region, so the
        first use of its shapes (cuDNN's choice of algorithms, the
        kernels' loads) is not timed. The carry freezes on invalid frames
        and the result is dropped: `state` is untouched."""
        chunk = self.chunk if chunk is None else chunk
        dummy = torch.zeros((chunk, self.batch, roi, roi, 3),
                            dtype=torch.uint8, device=self.device)
        novalid = torch.zeros((chunk, self.batch), dtype=torch.bool,
                              device=self.device)
        _, outs = self._run(state, dummy, novalid, self._origin0,
                            donate=False)
        outs[0].cpu()

    @staticmethod
    def _roi_slice(block, pos_h, roi):
        """Cut (roi x roi) windows centred on pos_h (B, 2), clamped
        inside the canvas, out of a (B, T, H, W, 3) uint8 block. Returns
        ((T, B, roi, roi, 3) uint8, ox (B,), oy (B,)) with the windows'
        origins in image coordinates."""
        b, t, h, w = block.shape[:4]
        ox = np.clip(np.round(pos_h[:, 0] - roi / 2), 0,
                     np.maximum(w - roi, 0))
        oy = np.clip(np.round(pos_h[:, 1] - roi / 2), 0,
                     np.maximum(h - roi, 0))
        roi_block = np.empty((t, b, roi, roi, 3), np.uint8)
        for v in range(b):
            xs, ys = int(ox[v]), int(oy[v])
            roi_block[:, v] = block[v, :, ys:ys + roi, xs:xs + roi]
        return roi_block, ox, oy

    def _clipped_windows(self, pos_np, sz_np, pos_h, sz_h, nb):
        """Each of the chunk's nb frames' crop windows [+_ROI_MARGIN] px,
        clipped
        to the true image (taps outside it read avg either way): frame t
        is stepped from the state after frame t-1 (the chunk-start state
        pos_h/sz_h for t=0). Yields (rx0, rx1, ry0, ry1), each (B,)."""
        im_hw = self._im_hw_b.cpu().numpy()
        prev_pos = np.concatenate([pos_h[None], pos_np[:nb - 1]])
        prev_sz = np.concatenate([sz_h[None], sz_np[:nb - 1]])
        for t in range(nb):
            x0, x1, y0, y1 = self._crop_window(prev_pos[t], prev_sz[t])
            yield (np.maximum(x0 - _ROI_MARGIN, 0),
                   np.minimum(x1 + _ROI_MARGIN, im_hw[:, 1] - 1),
                   np.maximum(y0 - _ROI_MARGIN, 0),
                   np.minimum(y1 + _ROI_MARGIN, im_hw[:, 0] - 1))

    def _roi_ok(self, pos_np, sz_np, pos_h, sz_h, ox, oy, roi, nb,
                valid_np) -> bool:
        """Exactness check of one returned chunk: every valid frame's
        clipped window lies inside [origin, origin + roi)."""
        for t, (rx0, rx1, ry0, ry1) in enumerate(self._clipped_windows(
                pos_np, sz_np, pos_h, sz_h, nb)):
            inside = (rx0 >= ox) & (rx1 <= ox + roi - 1) \
                & (ry0 >= oy) & (ry1 <= oy + roi - 1)
            if not (inside | ~valid_np[t]).all():
                return False
        return True

    def _roi_needed(self, pos_np, sz_np, pos_h, sz_h, anchor, nb,
                    valid_np) -> float:
        """The least ROI, centred on the chunk's anchor, that holds every
        clipped window of the chunk's true trajectory. The clamped
        origin `_roi_slice` places covers at least as much of the canvas
        as the centred one, so a failed `_roi_ok` means needed > roi and
        escalating to `needed` converges in one replay."""
        need = 0.0
        for t, (rx0, rx1, ry0, ry1) in enumerate(self._clipped_windows(
                pos_np, sz_np, pos_h, sz_h, nb)):
            half = np.maximum.reduce(
                [anchor[:, 0] - rx0, rx1 - anchor[:, 0],
                 anchor[:, 1] - ry0, ry1 - anchor[:, 1]])
            need = max(need, float(np.max(np.where(valid_np[t], half, 0.0))))
        # +2: inclusive-span and np.round(origin) slack
        return 2.0 * need + 2.0

    def track_batch_roi(self, state: EngineState, frames_u8: np.ndarray,
                        n_valid: np.ndarray, roi: int = 384,
                        chunk: int = None):
        """`track_batch` that uploads, per chunk, only a (roi x roi)
        window of each lane around its last known position instead of
        the canvas (`usot_tpu/tracker/engine.py:1034-1228`). Same
        arguments and returns as `track_batch`.

        Exactness is checked, not assumed: when a chunk's positions come
        back, the host recomputes every frame's crop window from them in
        f64 (`_crop_window`) and checks that it lies inside the window
        uploaded; a chunk that fails is REPLAYED with full frames from
        its input state, which `run_chunk(donate=False)` kept. Accepted
        chunks read the same pixels with the same bilinear weights as
        `track_batch` (the crop's taps are computed in image coordinates,
        `subwindow_gather`'s origin), so their outputs are bitwise
        `track_batch`'s where the model's kernels are deterministic.

        The next chunk is dispatched before the current one is checked,
        anchored at the last position the host knows (one chunk stale),
        so the host's slice and upload overlap the device's chunk; a
        failed chunk discards it. Every replay re-sizes the ROI from the
        replayed trajectory (`_roi_needed`); when the ROI reaches 80 % of
        a frame, or more than 40 % of 5+ chunks replayed, the rest of the
        run goes to `track_batch`. chunk: frames per dispatch (default
        `self.chunk`): the drift headroom, hence the ROI, grows with it.

        Telemetry on the engine after a run: roi_accepted (ROI chunks
        kept), roi_replays, roi_chunks (ROI dispatches, discarded
        speculative ones included), roi_escalations, roi_final,
        roi_fallback, roi_bytes_sent, roi_bytes_full_equiv."""
        chunk = self.chunk if chunk is None else chunk
        b, n = frames_u8.shape[:2]
        if b != self.batch:
            raise ValueError(f"{b} lanes for a batch of {self.batch}")
        h_im, w_im = frames_u8.shape[2], frames_u8.shape[3]
        n_valid = np.asarray(n_valid)
        self.roi_accepted = 0
        self.roi_replays = 0
        self.roi_chunks = 0
        self.roi_escalations = 0
        self.roi_final = roi
        self.roi_fallback = False
        self.roi_bytes_sent = 0
        self.roi_bytes_full_equiv = 0
        if roi >= min(h_im, w_im):
            self.roi_fallback = True
            return self.track_batch(state, frames_u8, n_valid)
        pos_h = state.pos.cpu().numpy().astype(np.float64)
        sz_h = state.sz.cpu().numpy().astype(np.float64)
        pending = {}          # chunk index -> (nb, outs on the device)
        starts = list(range(0, n, chunk))

        def prep(i):
            block = frames_u8[:, i:i + chunk]
            nb = block.shape[1]
            if nb < chunk:
                pad = np.repeat(block[:, -1:], chunk - nb, axis=1)
                block = np.concatenate([block, pad], axis=1)
            valid = np.arange(chunk)[:, None] + i < n_valid[None, :]
            return block, nb, valid

        def host_pos_sz(outs):
            return [o.cpu().numpy().astype(np.float64) for o in outs[:2]]

        def replay(rec):
            """Full-frame replay of a failed chunk from its saved input
            state, which it consumes."""
            block_tb = np.ascontiguousarray(np.swapaxes(rec["block"], 0, 1))
            st, outs = self._run(rec["state_in"],
                                 *self._upload(block_tb, rec["valid"]),
                                 self._origin0, donate=True)
            self.roi_bytes_sent += block_tb.nbytes
            return st, outs

        def dispatch(j, anchor_pos, state_in, cur_roi):
            block, nb, valid = prep(starts[j])
            roi_block, ox, oy = self._roi_slice(block, anchor_pos, cur_roi)
            st, outs = self._run(state_in, *self._upload(roi_block, valid),
                                 self._f32(np.stack([ox, oy], -1)),
                                 donate=False)
            self.roi_chunks += 1
            self.roi_bytes_sent += roi_block.nbytes
            self.roi_bytes_full_equiv += b * chunk * h_im * w_im * 3
            return dict(j=j, nb=nb, block=block, valid=valid, ox=ox, oy=oy,
                        roi=cur_roi, state_in=state_in, state_out=st,
                        outs=outs, anchor=np.asarray(anchor_pos, np.float64))

        def hand_off(state, i_rest):
            """The rest of the run on full frames (`track_batch`): ROI
            streaming stopped paying for itself."""
            self.roi_fallback = True
            self.roi_final = min(h_im, w_im)
            done = self._collate([pending[k] for k in sorted(pending)])
            if i_rest >= n:
                return (state,) + done
            state, *rest = self.track_batch(
                state, frames_u8[:, i_rest:],
                np.clip(n_valid - i_rest, 0, n - i_rest))
            return (state,) + tuple(np.concatenate([a, r], axis=1)
                                    for a, r in zip(done, rest))

        inflight = []
        j = 0             # next chunk index to dispatch
        while j < len(starts) or inflight:
            while j < len(starts) and len(inflight) < 2:
                # anchor: the last position the host knows (exact for the
                # first chunk in flight, one chunk stale for the next)
                st_in = inflight[-1]["state_out"] if inflight else state
                inflight.append(dispatch(j, pos_h, st_in, roi))
                j += 1
            rec = inflight.pop(0)
            nb = rec["nb"]
            pos_np, sz_np = host_pos_sz(rec["outs"])
            if self._roi_ok(pos_np, sz_np, pos_h, sz_h, rec["ox"],
                            rec["oy"], rec["roi"], nb, rec["valid"]):
                state = rec["state_out"]
                pending[rec["j"]] = (nb, rec["outs"])
                self.roi_accepted += 1
            else:
                # the speculative successor read a wrong carry: drop it
                # and rewind the dispatch cursor
                j = rec["j"] + 1
                inflight.clear()
                self.roi_replays += 1
                state, outs = replay(rec)
                pending[rec["j"]] = (nb, outs)
                pos_np, sz_np = host_pos_sz(outs)
                # pos_h/sz_h still hold the state entering rec, and
                # rec its anchor: the size that would have held it
                need = self._roi_needed(pos_np, sz_np, pos_h, sz_h,
                                        rec["anchor"], nb, rec["valid"])
                new_roi = int(-(-max(need, roi + 1.0) // 32) * 32)
                if new_roi > roi:
                    self.roi_escalations += 1
                frac = self.roi_replays / max(self.roi_chunks, 1)
                if (new_roi >= min(h_im, w_im)
                        or new_roi * new_roi >= 0.8 * h_im * w_im
                        or (self.roi_chunks >= 5 and frac > 0.4)):
                    return hand_off(state, starts[j] if j < len(starts)
                                    else n)
                roi = new_roi
                self.roi_final = roi
            pos_h = pos_np[nb - 1]
            sz_h = sz_np[nb - 1]
        return (state,) + self._collate([pending[k] for k in sorted(pending)])


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
