"""Lockstep benchmark protocols on `BatchScanEngine`: VOT restart and lane
refill.

Counterpart of `usot_tpu/tracker/lockstep.py`, with the same protocol
semantics. The engine tracks B videos in lockstep on the card; this
module puts the two host-side benchmark protocols on top of it:

- **VOT restart** (ref: scripts/test_usot.py:85-103): where the predicted
  box stops overlapping the ground truth, the video's row is 2, the next
  four are 0, and the tracker re-initialises from the ground truth at
  f + 5. Every chunk's positions come back to the host and are checked
  lane by lane; a failed lane gets a fresh init spliced into its lane of
  the pre-chunk state (`BatchScanEngine.splice_lane`), which
  `run_chunk(donate=False)` kept intact, and the chunk is replayed. The
  other lanes replay the same program on the same inputs, so they come
  out the same; a restart costs one more chunk.
- **Lane refill**: benchmarks other than VOT have long-tailed video
  lengths (LaSOT: 1k-10k frames), and padding every lane to the longest
  video wastes most of the batch. Videos are taken longest-first and a
  lane whose video ended starts the next pending video at the chunk
  boundary. Refill decisions read only the host-known video lengths, so
  no chunk waits for the card; positions are collated once at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from usot_tpu_torch.core.geometry import get_axis_aligned_bbox
from usot_tpu_torch.eval.polygon import poly_iou


def _lane_block(canvases, lane_vids, lane_next, n_frames, chunk):
    """One (T, B, ch, cw, 3) uint8 block from per-lane videos (the
    counterpart of JAX's `_flat_block`, in the port's frame layout).

    canvases[v]: (n_v, ch, cw, 3) padded frames; lane_vids[b]: video id,
    or -1 for an idle lane; lane_next[b]: the lane's next local frame.
    Past a video's end its last frame repeats (padding, which the caller
    masks invalid)."""
    b = len(lane_vids)
    ch, cw = next(c.shape[1:3] for c in canvases)
    block = np.zeros((chunk, b, ch, cw, 3), np.uint8)
    for lane in range(b):
        v = lane_vids[lane]
        if v < 0:
            continue
        canv, n = canvases[v], n_frames[v]
        f0 = lane_next[lane]
        hi = min(f0 + chunk, n)
        k = max(hi - f0, 0)
        if k > 0:
            block[:k, lane] = canv[f0:hi]
        if k < chunk:
            block[k:, lane] = canv[min(max(hi - 1, 0), n - 1)]
    return block


def _to_device(engine, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(engine.device)


# ---------------------------------------------------------------------
# VOT restart protocol
# ---------------------------------------------------------------------

class VOTLaneResult:
    """One video's protocol outcome: its rows in the reference result
    file's terms (1 init, a bbox, 2 failure, 0 skipped), and the frame
    from which a scan engine at the other instance size must finish it
    when a restart flips the instance size (`spill_from`, else None)."""

    def __init__(self, n):
        self.regions = [None] * n
        self.spill_from = None


def stage_vot_blocks(engine, canvases):
    """Upload every chunk's frame block of `run_vot_group` to the card
    first. Lanes are pinned to videos (absolute frame index == local),
    so the blocks do not depend on restarts: the protocol loop then runs
    on the card without waiting for the host link. Returns {chunk start
    frame: (T, B, ch, cw, 3) uint8 tensor}."""
    b = len(canvases)
    n_frames = [len(c) for c in canvases]
    staged = {cs: _to_device(engine, _lane_block(
        canvases, list(range(b)), [cs] * b, n_frames, engine.chunk))
        for cs in range(1, max(n_frames), engine.chunk)}
    for blk in staged.values():
        blk[0, 0, 0, 0].cpu()    # every upload done
    return staged


def run_vot_group(engine, runner, canvases, hws, gts, stage: bool = False,
                  stats: dict = None, staged_blocks: dict = None):
    """Track one lockstep group of VOT videos with the restart protocol.

    engine: `BatchScanEngine` with batch == len(canvases).
    canvases[v]: (n_v, ch, cw, 3) uint8, the real frames top-left;
    hws[v]: (h, w) true frame size; gts[v]: per-frame ground truth (a
    4-number rect or an 8-number polygon per row).
    The reference re-chooses big/small at every init
    (`TrackerConfig.instance_of`); a restart whose choice differs from
    the engine's search size is SPILLED (`spill_from`) for the caller to
    finish on a scan engine of that size.
    stage=True uploads every chunk's block before the protocol loop
    (`stage_vot_blocks`); `staged_blocks` passes in blocks the caller
    staged once, so repeated runs do not upload again (the results are
    bitwise those of stage=True); a replay reuses its chunk's block
    either way.
    stats: optional dict that receives the counts "chunks" (chunk runs,
    replays included) and "replays".

    Returns list[VOTLaneResult], frame by frame the rows of the
    single-video scan path (`cli/test.py` `_scan_vot_loop`)."""
    b = len(canvases)
    if b != engine.batch:
        raise ValueError(f"{b} videos for a batch of {engine.batch}")
    chunk = engine.chunk
    n_frames = [len(c) for c in canvases]
    max_n = max(n_frames)
    results = [VOTLaneResult(n) for n in n_frames]
    stats = {} if stats is None else stats
    stats.update(chunks=0, replays=0)

    videos = []
    for v in range(b):
        cx, cy, w, h = get_axis_aligned_bbox(np.asarray(gts[v][0]))
        im0 = canvases[v][0][:hws[v][0], :hws[v][1]]
        videos.append((im0, np.array([cx, cy]), np.array([w, h])))
        results[v].regions[0] = 1
    state = engine.init_batch(videos, runner)

    # per-lane protocol bookkeeping (host ints)
    MODE_TRACK, MODE_AWAIT, MODE_DONE = 0, 1, 2
    mode = [MODE_TRACK if n > 1 else MODE_DONE for n in n_frames]
    resume = [1] * b        # first actively tracked frame
    consumed = [0] * b      # last frame whose row is written
    await_r = [0] * b       # pending re-init frame (MODE_AWAIT)

    instance_size = engine.p.instance_size

    def pick_instance(v, r):
        cx, cy, w, h = get_axis_aligned_bbox(np.asarray(gts[v][r]))
        return engine.p.instance_of((w, h), *hws[v]), (cx, cy, w, h)

    def do_splice(st, v, r):
        """Re-init lane v at frame r into state `st`. Returns
        (st, resumed: bool)."""
        inst, (cx, cy, w, h) = pick_instance(v, r)
        if inst != instance_size:
            results[v].spill_from = r
            mode[v] = MODE_DONE
            return st, False
        results[v].regions[r] = 1
        consumed[v] = r
        if r + 1 >= n_frames[v]:
            mode[v] = MODE_DONE          # init on the last frame: done
            return st, False
        im = canvases[v][r][:hws[v][0], :hws[v][1]]
        lane = engine.make_lane_state(im, np.array([cx, cy], float),
                                      np.array([w, h], float), runner)
        st = engine.splice_lane(st, v, lane)
        mode[v] = MODE_TRACK
        resume[v] = r + 1
        return st, True

    staged = staged_blocks
    if staged is None and stage:
        staged = stage_vot_blocks(engine, canvases)

    for cs in range(1, max_n, chunk):
        ce = min(cs + chunk, max_n)
        # restarts whose resume frame falls inside (or before) this chunk
        for v in range(b):
            if mode[v] == MODE_AWAIT and await_r[v] + 1 < cs + chunk:
                state, _ = do_splice(state, v, await_r[v])
        if all(m == MODE_DONE for m in mode):
            break
        if not any(m == MODE_TRACK for m in mode):
            continue  # only re-inits pending beyond this chunk: skip it

        block = staged[cs] if staged is not None else _to_device(
            engine, _lane_block(canvases, list(range(b)), [cs] * b,
                                n_frames, chunk))
        # run the chunk, consume it, splice failed lanes into the KEPT
        # pre-chunk state and run it again until no lane newly fails
        pre_state = state
        while True:
            valid = np.zeros((chunk, b), bool)
            for v in range(b):
                if mode[v] != MODE_TRACK:
                    continue
                lo = max(resume[v], cs)
                hi = min(n_frames[v], ce)
                if lo < hi:
                    valid[lo - cs:hi - cs, v] = True
            post_state, outs = engine.run_chunk(
                pre_state, block, _to_device(engine, valid), donate=False)
            stats["chunks"] += 1
            pos = outs[0].cpu().numpy().astype(np.float64)   # (T, B, 2)
            sz = outs[1].cpu().numpy().astype(np.float64)

            replay = False
            for v in range(b):
                if mode[v] != MODE_TRACK:
                    continue
                f = max(consumed[v] + 1, cs)
                while f < min(n_frames[v], ce):
                    t = f - cs
                    loc = np.array([pos[t, v, 0] - sz[t, v, 0] / 2,
                                    pos[t, v, 1] - sz[t, v, 1] / 2,
                                    sz[t, v, 0], sz[t, v, 1]], np.float64)
                    if poly_iou(np.asarray(gts[v][f]), loc) <= 0:
                        results[v].regions[f] = 2
                        for f2 in range(f + 1, min(f + 5, n_frames[v])):
                            results[v].regions[f2] = 0
                        consumed[v] = min(f + 4, n_frames[v] - 1)
                        r = f + 5
                        if r >= n_frames[v]:
                            mode[v] = MODE_DONE
                        elif r + 1 < cs + chunk:
                            pre_state, resumed = do_splice(pre_state, v, r)
                            replay = replay or resumed
                        else:
                            mode[v] = MODE_AWAIT
                            await_r[v] = r
                        break
                    results[v].regions[f] = loc
                    consumed[v] = f
                    f += 1
                if mode[v] == MODE_TRACK and consumed[v] >= n_frames[v] - 1:
                    mode[v] = MODE_DONE
            if not replay:
                state = post_state
                break
            stats["replays"] += 1

    # lanes still awaiting a re-init past the last tracked frame: the
    # init itself is recorded (scan path: init, then nothing to track)
    for v in range(b):
        if mode[v] == MODE_AWAIT and await_r[v] <= n_frames[v] - 1:
            inst, _ = pick_instance(v, await_r[v])
            if inst != instance_size:
                results[v].spill_from = await_r[v]
            else:
                results[v].regions[await_r[v]] = 1
    return results


# ---------------------------------------------------------------------
# Lane refill (lockstep evaluation of benchmarks other than VOT)
# ---------------------------------------------------------------------

def run_refill_group(engine, runner, videos, stats: dict = None):
    """Track a pool of videos through a B-lane `BatchScanEngine` with lane
    refill: videos are taken longest-first, and when a lane's video
    ends, the next pending video is spliced into that lane at the next
    chunk boundary (all of a boundary's refills in one batched init and
    one `splice_lanes`).

    videos: list of dicts with keys name, canvas ((n, ch, cw, 3) uint8,
    frame 0 included), h, w, init_pos (2,), init_sz (2,).
    stats: optional dict that receives the counts "chunks" and
    "refills".

    Returns {name: (pos, sz, score)} as float64 numpy, pos/sz (n-1, 2)
    and score (n-1,) per video."""
    b = engine.batch
    chunk = engine.chunk
    order = sorted(range(len(videos)),
                   key=lambda v: -len(videos[v]["canvas"]))
    canvases = [vid["canvas"] for vid in videos]
    n_frames = [len(c) for c in canvases]
    stats = {} if stats is None else stats
    stats.update(chunks=0, refills=0)

    def init_of(v):
        vid = videos[v]
        return (vid["canvas"][0][:vid["h"], :vid["w"]],
                np.asarray(vid["init_pos"], float),
                np.asarray(vid["init_sz"], float))

    # the B longest videos through the batched init; idle lanes (fewer
    # videos than lanes) repeat lane 0's video, masked invalid
    first = order[:b]
    pending = list(order[b:])
    init_list = [init_of(v) for v in first]
    init_list += [init_list[0]] * (b - len(init_list))
    state = engine.init_batch(init_list, runner)

    lane_vid = [first[i] if i < len(first) else -1 for i in range(b)]
    lane_next = [1] * b               # next local frame to track
    records = []                      # per chunk: (outs, per-lane snap)

    def active(lane):
        v = lane_vid[lane]
        return v >= 0 and lane_next[lane] < n_frames[v]

    while any(active(lane) for lane in range(b)):
        valid = np.zeros((chunk, b), bool)
        snap = []                     # (video, local start, frames)
        for lane in range(b):
            v = lane_vid[lane]
            k = min(chunk, n_frames[v] - lane_next[lane]) \
                if active(lane) else 0
            valid[:k, lane] = True
            snap.append((v, lane_next[lane], k))
        block = _lane_block(canvases, lane_vid, lane_next, n_frames, chunk)
        state, outs = engine.run_chunk(state, _to_device(engine, block),
                                       _to_device(engine, valid),
                                       donate=True)
        stats["chunks"] += 1
        records.append((outs, snap))

        # advance, and refill at the boundary (host-only decisions)
        refills = []
        for lane in range(b):
            v, f0, k = snap[lane]
            if v < 0:
                continue
            lane_next[lane] = f0 + k
            if lane_next[lane] >= n_frames[v] and pending:
                nv = pending.pop(0)
                refills.append((lane, nv))
                lane_vid[lane] = nv
                lane_next[lane] = 1
        if refills:
            lane_sts = engine.make_lane_states(
                [init_of(nv) for _, nv in refills], runner)
            state = engine.splice_lanes(
                state, [lane for lane, _ in refills], lane_sts)
            stats["refills"] += len(refills)

    # collate: one copy to the host per chunk, after the last one ran
    out = {v: tuple(np.zeros((n_frames[v] - 1,) + s, np.float64)
                    for s in ((2,), (2,), ()))
           for v in range(len(videos))}
    for outs, snap in records:
        host = [o.cpu().numpy() for o in outs]
        for lane, (v, f0, k) in enumerate(snap):
            if v < 0 or k == 0:
                continue
            for dst, src in zip(out[v], host):
                dst[f0 - 1:f0 - 1 + k] = src[:k, lane]
    return {vid["name"]: out[v] for v, vid in enumerate(videos)}
