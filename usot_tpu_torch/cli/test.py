"""Benchmark test CLI of the port (ref: scripts/test_usot.py).

    python -m usot_tpu_torch.cli.test --dataset OTB2015 --engine batch

Counterpart of `usot_tpu/cli/test.py`: tracks a benchmark and writes the
raw result files in the reference's layouts, which
`usot_tpu.cli.evaluate` scores unchanged:
  VOT:  <result_dir>/<ds>/<arch>/baseline/<video>/<video>_001.txt with
        the 1/bbox/2/0 restart protocol (re-init 5 frames after a failure)
  GOT:  <result_dir>/<ds>/<arch>/<video>/<video>_001.txt + _time.txt
  else: <result_dir>/<ds>/<arch>/<video>.txt (1-indexed x, y)
Runs on the GPU unless `--device cpu` is given; without a GPU and without
it, it raises. Frame files are decoded by `data.imageio.read_image`
(OpenCV or Pillow), or by the `reader` that `main(argv, reader)` is
given. `--dtype bfloat16` runs every engine in bfloat16
over float32 weights (`build_usot(dtype=...)`); `--resume` takes a torch
`.pth` or a flax checkpoint (`.msgpack`, `.ckpt`: any other suffix), as
the JAX CLI's `load_variables` does.

`--arch OSTrack-384 --engine batch` tracks with OSTrack-384 instead
(`models/ostrack.py`, `tracker/ostrack_engine.py`), `--batch` videos at
a time, one lane each; `--resume` then takes OSTrack's checkpoint, its
weights loaded by key name.
"""
from __future__ import annotations

import argparse
import os
import time
from os.path import join

import numpy as np
import torch

from usot_tpu_torch.core.device import f32_numerics, resolve_device
from usot_tpu_torch.core.geometry import cxy_wh_2_rect, get_axis_aligned_bbox
from usot_tpu_torch.data.benchmark import load_dataset
from usot_tpu_torch.data.imageio import read_image
from usot_tpu_torch.eval.polygon import poly_iou
from usot_tpu_torch.tracker.config import TrackerConfig
from usot_tpu_torch.tracker.engine import BatchScanEngine, ScanEngine
from usot_tpu_torch.tracker.lockstep import run_refill_group, run_vot_group


OSTRACK = "OSTrack-384"
DEFAULT_RESUME = {"USOT": "var/snapshot/USOT_star.pth",
                  OSTRACK: "var/snapshot/OSTrack_ep0300.pth.tar"}


def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="USOT testing (PyTorch)")
    parser.add_argument("--arch", default="USOT",
                        help="the tracker, and the name of its result "
                        "directory: USOT (USOT*, any engine) or "
                        f"{OSTRACK} (OSTrack-384, ECCV 2022: ViT-B/16 "
                        "one-stream with candidate elimination, "
                        "--engine batch only, one lane per video, frames "
                        "read as RGB, OTB-style result files)")
    parser.add_argument("--resume", default=None,
                        help="USOT: a PyTorch state dict in the "
                        "reference's layout (.pth/.model/.tar: a published "
                        "USOT*.pth; nested under 'state_dict' and "
                        "'module.'-style prefixes are accepted) or a flax "
                        "checkpoint of usot_tpu (any other suffix: "
                        ".msgpack, .ckpt); loaded strictly. "
                        f"{OSTRACK}: OSTrack's checkpoint "
                        "(OSTrack_ep0300.pth.tar; its 'net' weights "
                        "loaded by key name, MAE's unused pos_embed and "
                        "cls_token ignored). A missing file means random "
                        "weights (USOT's with calibrated BN stats). "
                        "Default: var/snapshot/USOT_star.pth, or "
                        "var/snapshot/OSTrack_ep0300.pth.tar")
    parser.add_argument("--dataset", default="VOT2018")
    parser.add_argument("--dataset_root", default=None)
    # NOT the reference's `type=bool` (scripts/test_usot.py:33), which
    # parses any non-empty string, "False" included, as True.
    parser.add_argument("--epoch_test", default=False, type=str2bool)
    parser.add_argument("--result_dir", default="var/result")
    parser.add_argument("--mem_size", default=4, type=int)
    parser.add_argument("--engine", default="parity",
                        choices=["parity", "scan", "batch"],
                        help="parity: host loop (reference-exact); "
                             "scan: one video's step on the device, "
                             "chunked; batch: several videos in lockstep")
    parser.add_argument("--chunk", default=32, type=int)
    parser.add_argument("--roi", default="0",
                        help="ROI streaming side length for the batch "
                        "engine (0 = full frames, 'auto' = sized from "
                        "the group's search windows): uploads only a "
                        "window around each target, with an exactness "
                        "replay on full frames")
    parser.add_argument("--roi-chunk", default=0, type=int,
                        help="ROI dispatch granularity (0 = --chunk). "
                        "Shorter chunks shrink the drift headroom the "
                        "ROI must cover, hence the bytes uploaded")
    parser.add_argument("--batch", default=8, type=int,
                        help="videos per lockstep group (engine=batch)")
    parser.add_argument("--refill", default=1, type=int,
                        help="engine=batch, non-VOT: refill finished "
                        "lanes with pending videos at chunk boundaries "
                        "(longest-first); 0 = fixed padded groups "
                        "(required for --roi)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="model compute dtype (every engine); the "
                        "parameters stay float32")
    parser.add_argument("--width", default=64, type=int,
                        help="backbone stage width base (dev-scale models)")
    parser.add_argument("--channels", default=256, type=int,
                        help="neck/head channels (dev-scale models)")
    parser.add_argument("--device", default=None,
                        help="torch device; default the GPU (raises "
                        "without one). 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    if args.resume is None:
        args.resume = DEFAULT_RESUME.get(args.arch, DEFAULT_RESUME["USOT"])
    return args


def _tracker_path(args) -> str:
    arch = args.arch
    if args.epoch_test:
        arch += os.path.splitext(os.path.basename(args.resume))[0]
    path = join(args.result_dir, args.dataset, arch)
    os.makedirs(path, exist_ok=True)
    return path


def _result_path(args, tracker_path, name) -> str:
    """The result file of one video."""
    if "VOT" in args.dataset:
        return join(tracker_path, "baseline", name, name + "_001.txt")
    if "GOT" in args.dataset:
        return join(tracker_path, name, name + "_001.txt")
    return join(tracker_path, f"{name}.txt")


def _write_got_times(tracker_path, name, times):
    with open(join(tracker_path, name, f"{name}_time.txt"), "w") as fh:
        for x in times:
            fh.write(f"{x:.6f}\n")


def track_video(tracker, runner, video, args, reader=None):
    """The parity tracker over one video (reference-exact host loop).
    `reader(src)` gives a frame's BGR uint8 array (default
    `read_image`)."""
    tracker_path = _tracker_path(args)
    is_vot, is_got = "VOT" in args.dataset, "GOT" in args.dataset
    result_path = _result_path(args, tracker_path, video["name"])
    if os.path.exists(result_path):
        return

    start_frame, toc = 0, 0.0
    regions, track_times = [], []
    image_files, gt = video["image_files"], video["gt"]
    state = None
    reader = reader or read_image
    for f, image_file in enumerate(image_files):
        im = reader(image_file)
        if im is None:
            continue
        tic = time.perf_counter()
        if f == start_frame:
            cx, cy, w, h = get_axis_aligned_bbox(np.asarray(gt[f]))
            state = tracker.init(im, np.array([cx, cy]), np.array([w, h]),
                                 runner)
            regions.append(1 if is_vot else gt[f])
        elif f > start_frame:
            state = tracker.track(state, im)
            location = cxy_wh_2_rect(state["target_pos"], state["target_sz"])
            b_overlap = poly_iou(np.asarray(gt[f]), location) \
                if is_vot else 1
            if b_overlap > 0:
                regions.append(location)
            else:
                regions.append(2)
                start_frame = f + 5
        else:
            regions.append(0)
        dt = time.perf_counter() - tic
        toc += dt
        if is_got:
            track_times.append(dt)

    _write_regions(result_path, regions, is_vot)
    if is_got:
        _write_got_times(tracker_path, video["name"], track_times)
    print("Video: {:12s} Time: {:2.1f}s Speed: {:3.1f}fps".format(
        video["name"], toc, f / max(toc, 1e-9)))


def _config(instance: int) -> TrackerConfig:
    p = TrackerConfig()
    p.instance_size = instance
    p.renew()
    p.sf_size = p.score_size
    return p


def _get_scan_engine(engines, model, runner, args, canvas_h, canvas_w,
                     im_h, im_w, target_sz):
    """ScanEngine per (canvas bucket, instance size), the instance size
    re-chosen at every init from the target area."""
    instance = TrackerConfig().instance_of(target_sz, im_h, im_w)
    key = (canvas_h, canvas_w, instance)
    if key not in engines:
        engines[key] = ScanEngine(
            model, _config(instance), im_h=canvas_h, im_w=canvas_w,
            max_frames=4096, chunk=args.chunk, device=runner.device)
    return engines[key]


def _scan_vot_loop(model, runner, engines, args, frames, padded, gt,
                   regions, start_frame, is_vot):
    """The scan engine's restart loop over one video, writing `regions`
    from `start_frame` on (restart protocol: ref test_usot.py:85-103).
    Shared by `track_video_scan` (start_frame=0) and by the batched VOT
    path's spills (a restart whose big/small search size differs from
    its lockstep group's is finished here)."""
    n = len(frames)
    im_h, im_w = frames[0].shape[:2]
    canvas_h, canvas_w = padded.shape[1:3]
    while start_frame < n:
        cx, cy, w, h = get_axis_aligned_bbox(np.asarray(gt[start_frame]))
        engine = _get_scan_engine(engines, model, runner, args, canvas_h,
                                  canvas_w, im_h, im_w, (w, h))
        state = engine.init_state(frames[start_frame], np.array([cx, cy]),
                                  np.array([w, h]), runner)
        regions[start_frame] = 1 if is_vot else gt[start_frame]
        if start_frame + 1 >= n:
            break

        def consume(chunk):
            """Copy one chunk to the host and check its overlaps; fills
            `regions` and returns the failure frame or None."""
            off, nb, outs = chunk
            pos = outs[0][:nb].cpu().numpy()
            sz = outs[1][:nb].cpu().numpy()
            for i in range(nb):
                f = start_frame + 1 + off + i
                location = np.array([pos[i][0] - sz[i][0] / 2,
                                     pos[i][1] - sz[i][1] / 2,
                                     sz[i][0], sz[i][1]], np.float64)
                if is_vot and poly_iou(np.asarray(gt[f]), location) <= 0:
                    regions[f] = 2
                    return f
                regions[f] = location
            return None

        # one chunk of lookahead: chunk i+1 is queued before chunk i is
        # read back, so a failure wastes at most one chunk
        failure_at = None
        pending = None
        for off, nb, state, outs in engine.iter_chunks(
                state, padded[start_frame + 1:], im_hw=(im_h, im_w)):
            if pending is not None:
                failure_at = consume(pending)
                pending = None
                if failure_at is not None:
                    break
            pending = (off, nb, outs)
        if failure_at is None and pending is not None:
            failure_at = consume(pending)
        if failure_at is None:
            break
        for f in range(failure_at + 1, min(failure_at + 5, n)):
            regions[f] = 0
        start_frame = failure_at + 5


def _write_regions(result_path, regions, is_vot):
    os.makedirs(os.path.dirname(result_path), exist_ok=True)
    with open(result_path, "w") as fin:
        for x in regions:
            if x is None:
                fin.write("0\n")
            elif isinstance(x, int):
                fin.write("{:d}\n".format(x))
            elif is_vot:
                fin.write(",".join(str(i) for i in np.asarray(x).ravel())
                          + "\n")
            else:
                bbox = list(np.asarray(x).ravel())
                fin.write(",".join(
                    str(i + 1) if idx in (0, 1) else str(i)
                    for idx, i in enumerate(bbox)) + "\n")


def _bucket(h, w):
    """The 128-px canvas bucket of a frame size: the engines take the
    valid image size as an input, so one engine serves a bucket."""
    return (h + 127) // 128 * 128, (w + 127) // 128 * 128


def _load_frames_padded(image_files, reader=None):
    """Decode a video and pad it onto its canvas bucket. Returns (frames
    as views into the canvas, (n, ch, cw, 3) canvas)."""
    frames = [(reader or read_image)(f) for f in image_files]
    n = len(frames)
    im_h, im_w = frames[0].shape[:2]
    padded = np.zeros((n,) + _bucket(im_h, im_w) + (3,), np.uint8)
    for fi, im in enumerate(frames):
        padded[fi, :im.shape[0], :im.shape[1]] = im
    frames = [padded[fi, :frames[fi].shape[0], :frames[fi].shape[1]]
              for fi in range(n)]
    return frames, padded


def track_video_scan(model, runner, video, args, engines, reader=None):
    """One video on the scan engine; a VOT restart re-enters the engine
    at frame f + 5 with a fresh init (the host checks the overlaps)."""
    tracker_path = _tracker_path(args)
    is_vot, is_got = "VOT" in args.dataset, "GOT" in args.dataset
    result_path = _result_path(args, tracker_path, video["name"])
    if os.path.exists(result_path):
        return

    frames, padded = _load_frames_padded(video["image_files"], reader)
    n = len(frames)
    t0 = time.perf_counter()
    regions = [None] * n
    _scan_vot_loop(model, runner, engines, args, frames, padded,
                   video["gt"], regions, 0, is_vot)
    _write_regions(result_path, regions, is_vot)
    toc = time.perf_counter() - t0
    if is_got:
        # the chunked engine has no per-frame host time: write the
        # amortised time of a frame
        _write_got_times(tracker_path, video["name"],
                         [toc / max(n, 1)] * n)
    print("Video: {:12s} Time: {:2.1f}s Speed: {:3.1f}fps".format(
        video["name"], toc, (n - 1) / max(toc, 1e-9)))


def _probe_groups(dataset, result_of, reader=None):
    """Pending videos grouped by (canvas bucket, instance size): one
    lockstep engine per group."""
    groups: dict = {}
    for name in dataset:
        video = dataset[name]
        if os.path.exists(result_of(video)):
            continue
        im0 = (reader or read_image)(video["image_files"][0])
        _, _, w, h = get_axis_aligned_bbox(np.asarray(video["gt"][0]))
        key = _bucket(*im0.shape[:2]) + (
            TrackerConfig().instance_of((w, h), *im0.shape[:2]),)
        groups.setdefault(key, []).append(name)
    return groups


def _make_batch_engine(engines, model, runner, instance, ch, cw, b, args,
                       max_frames=4096):
    ekey = (ch, cw, instance, b)
    if ekey not in engines:
        engines[ekey] = BatchScanEngine(
            model, _config(instance), canvas_h=ch, canvas_w=cw, batch=b,
            max_frames=max_frames, chunk=args.chunk, device=runner.device)
    return engines[ekey]


def _load_group_canvases(dataset, names, ch, cw, reader=None):
    """Decode and pad every video of a group. Returns (canvases, hws):
    canvases[v] (n_v, ch, cw, 3) uint8 with the real frames top-left,
    hws[v] = (h, w)."""
    canvases, hws = [], []
    for name in names:
        frames = [im for im in map(reader or read_image,
                                   dataset[name]["image_files"])
                  if im is not None]
        canvas = np.zeros((len(frames), ch, cw, 3), np.uint8)
        for fi, im in enumerate(frames):
            canvas[fi, :im.shape[0], :im.shape[1]] = im
        canvases.append(canvas)
        hws.append(frames[0].shape[:2])
    return canvases, hws


def _init_box(video):
    cx, cy, w, h = get_axis_aligned_bbox(np.asarray(video["gt"][0]))
    return np.array([cx, cy]), np.array([w, h])


def _write_result(dataset, tracker_path, name, pos, sz):
    """One video's OTB-style result file: its first ground-truth box,
    then each tracked frame's [x, y, w, h]."""
    rects = [np.asarray(dataset[name]["gt"][0], np.float64).ravel()]
    rects += [np.array([pos[f, 0] - sz[f, 0] / 2, pos[f, 1] - sz[f, 1] / 2,
                        sz[f, 0], sz[f, 1]], np.float64)
              for f in range(len(pos))]
    _write_regions(join(tracker_path, f"{name}.txt"), rects, False)


def _track_fixed_groups(dataset, groups, args, make_engine, track,
                        reader=None, rgb=False):
    """Fixed padded groups: each group of videos (keyed by canvas bucket
    (ch, cw, ...)) `--batch` at a time, one lane per video, every lane
    padded to the group's longest video. make_engine(key, lanes) -> a
    batch engine; track(engine, inits, frames (B, N, ch, cw, 3),
    n_valid (B,)) -> (pos, sz, a record's extra entries). rgb: frames
    turned from BGR to RGB first. Returns one record per group."""
    tracker_path = _tracker_path(args)
    records = []
    for key, names in groups.items():
        ch, cw = key[:2]
        for i in range(0, len(names), args.batch):
            group = names[i:i + args.batch]
            b = len(group)
            engine = make_engine(key, b)
            t0 = time.perf_counter()
            canvases, hws = _load_group_canvases(dataset, group, ch, cw,
                                                 reader)
            if rgb:
                canvases = [np.ascontiguousarray(c[..., ::-1])
                            for c in canvases]
            inits = [(c[0][:h, :w],) + _init_box(dataset[name])
                     for c, (h, w), name in zip(canvases, hws, group)]
            n_valid = np.array([len(c) - 1 for c in canvases])
            frames = np.zeros((b, n_valid.max(), ch, cw, 3), np.uint8)
            for vi, canvas in enumerate(canvases):
                frames[vi, :n_valid[vi]] = canvas[1:]
            pos, sz, rec = track(engine, inits, frames, n_valid)
            total = 0
            for vi, name in enumerate(group):
                n = int(n_valid[vi])
                _write_result(dataset, tracker_path, name, pos[vi, :n],
                              sz[vi, :n])
                total += n + 1
            dt = time.perf_counter() - t0
            records.append(dict(videos=b, frames=total, lanes=b, seconds=dt,
                                fps=total / max(dt, 1e-9), **rec))
            print("Group of {:d} videos ({:d} frames): {:.1f}s "
                  "-> {:.1f} fps aggregate".format(
                      b, total, dt, total / max(dt, 1e-9)))
    return records


def track_dataset_batched(model, runner, dataset, args, reader=None):
    """Lockstep evaluation of a whole benchmark (protocols other than
    VOT): videos grouped by (canvas bucket, instance size), B lanes at a
    time on a `BatchScanEngine`.

    --refill 1 (default): longest-first with lane refill
    (`tracker.lockstep.run_refill_group`), so length-skewed benchmarks do
    not pad every lane to the longest video. --refill 0: fixed padded
    groups (`_track_fixed_groups`), the path of --roi streaming. Returns
    one record per group (videos, frames, lanes, seconds, fps, and the
    refill or ROI counts)."""
    tracker_path = _tracker_path(args)
    groups = _probe_groups(dataset,
                           lambda v: join(tracker_path, f"{v['name']}.txt"),
                           reader)
    engines: dict = {}

    def make_engine(key, b):
        ch, cw, instance = key
        return _make_batch_engine(engines, model, runner, instance, ch, cw,
                                  b, args)

    roi_on = args.roi == "auto" or int(args.roi) != 0
    if args.refill and not roi_on:
        records = []
        for (ch, cw, instance), names in groups.items():
            t0 = time.perf_counter()
            canvases, hws = _load_group_canvases(dataset, names, ch, cw,
                                                 reader)
            videos = []
            for vi, name in enumerate(names):
                pos0, sz0 = _init_box(dataset[name])
                videos.append(dict(name=name, canvas=canvases[vi],
                                   h=hws[vi][0], w=hws[vi][1],
                                   init_pos=pos0, init_sz=sz0))
            b = min(args.batch, len(names))
            engine = make_engine((ch, cw, instance), b)
            stats = {}
            results = run_refill_group(engine, runner, videos, stats=stats)
            total = 0
            for name in names:
                pos, sz, _ = results[name]
                _write_result(dataset, tracker_path, name, pos, sz)
                total += len(pos) + 1
            dt = time.perf_counter() - t0
            records.append(dict(videos=len(names), frames=total, lanes=b,
                                seconds=dt, fps=total / max(dt, 1e-9),
                                **stats))
            print("Refill group of {:d} videos ({:d} frames, {:d} lanes):"
                  " {:.1f}s -> {:.1f} fps aggregate".format(
                      len(names), total, b, dt, total / max(dt, 1e-9)))
        return records

    def track(engine, inits, frames, n_valid):
        state = engine.init_batch(inits, runner)
        roi_chunk = args.roi_chunk or None
        roi = engine.suggest_roi(state, chunk=roi_chunk) \
            if args.roi == "auto" else int(args.roi)
        rec = dict(roi=roi)
        if roi:
            _, pos, sz, _ = engine.track_batch_roi(
                state, frames, n_valid, roi=roi, chunk=roi_chunk)
            rec.update({k: getattr(engine, k) for k in (
                "roi_accepted", "roi_replays", "roi_chunks",
                "roi_escalations", "roi_final", "roi_fallback",
                "roi_bytes_sent", "roi_bytes_full_equiv")})
        else:
            _, pos, sz, _ = engine.track_batch(state, frames, n_valid)
        return pos, sz, rec

    return _track_fixed_groups(dataset, groups, args, make_engine, track,
                               reader)


def track_dataset_ostrack(model, dataset, args, reader=None):
    """OSTrack over a dataset (`--arch OSTrack-384 --engine batch`): the
    videos grouped by canvas bucket, `--batch` at a time, one lane per
    video, on an `OSTrackBatchEngine` (`_track_fixed_groups`). Frames are
    turned from BGR to RGB, as OSTrack reads them. Result files in OTB's
    layout. Returns one record per group."""
    from usot_tpu_torch.tracker.ostrack_engine import OSTrackBatchEngine

    tracker_path = _tracker_path(args)
    groups: dict = {}
    for name in dataset:
        if os.path.exists(join(tracker_path, f"{name}.txt")):
            continue
        im0 = (reader or read_image)(dataset[name]["image_files"][0])
        groups.setdefault(_bucket(*im0.shape[:2]), []).append(name)

    def make_engine(key, b):
        return OSTrackBatchEngine(model, b, chunk=args.chunk,
                                  device=next(model.parameters()).device)

    def track(engine, inits, frames, n_valid):
        _, pos, sz, *_ = engine.track_batch(engine.init_batch(inits), frames,
                                            n_valid)
        return pos, sz, {}

    return _track_fixed_groups(dataset, groups, args, make_engine, track,
                               reader, rgb=True)


def load_ostrack(args, device):
    """OSTrack-384 on `device` in `--dtype`: `--resume`'s weights (an
    OSTrack checkpoint, by key name), or (no such file) seeded random
    weights with OSTrack's initialisers."""
    from usot_tpu_torch.models.ostrack import (build_ostrack, init_ostrack,
                                               load_ostrack_state)

    model = build_ostrack(dtype=torch.bfloat16 if args.dtype == "bfloat16"
                          else torch.float32)
    if args.resume and os.path.exists(args.resume):
        load_ostrack_state(model, torch.load(args.resume, map_location="cpu",
                                             weights_only=False))
    else:
        print(f"warning: checkpoint {args.resume} not found; random init")
        init_ostrack(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


def track_dataset_vot_batched(model, runner, dataset, args, reader=None):
    """Lockstep VOT evaluation WITH the restart protocol: grouped lanes,
    overlaps checked on the host, per-lane re-init splice and chunk
    replay (`tracker.lockstep.run_vot_group`). A restart that flips the
    big/small instance size spills to the scan engine, which finishes the
    video from that frame: the protocol of --engine scan (ref:
    scripts/test_usot.py:85-103). Returns one record per group (videos,
    frames, lanes, seconds, fps, chunks, replays, and `spilled`: the
    names of the videos spilled)."""
    tracker_path = _tracker_path(args)
    groups = _probe_groups(
        dataset, lambda v: _result_path(args, tracker_path, v["name"]),
        reader)
    engines: dict = {}
    scan_engines: dict = {}
    records = []

    for (ch, cw, instance), names in groups.items():
        for i in range(0, len(names), args.batch):
            group = names[i:i + args.batch]
            b = len(group)
            t0 = time.perf_counter()
            canvases, hws = _load_group_canvases(dataset, group, ch, cw,
                                                 reader)
            gts = [dataset[name]["gt"] for name in group]
            engine = _make_batch_engine(engines, model, runner, instance,
                                        ch, cw, b, args, max_frames=2048)
            stats = {}
            results = run_vot_group(engine, runner, canvases, hws, gts,
                                    stats=stats)

            total, spilled = 0, []
            for vi, name in enumerate(group):
                res = results[vi]
                if res.spill_from is not None:
                    spilled.append(name)
                    print(f"spill: {name} re-init at frame "
                          f"{res.spill_from} flipped the instance size; "
                          "finishing on the scan engine")
                    h, w = hws[vi]
                    frames = [canvases[vi][fi, :h, :w]
                              for fi in range(len(canvases[vi]))]
                    _scan_vot_loop(model, runner, scan_engines, args,
                                   frames, canvases[vi], gts[vi],
                                   res.regions, res.spill_from, True)
                _write_regions(_result_path(args, tracker_path, name),
                               res.regions, True)
                total += len(res.regions)
            dt = time.perf_counter() - t0
            records.append(dict(videos=b, frames=total, lanes=b, seconds=dt,
                                fps=total / max(dt, 1e-9), spilled=spilled,
                                **stats))
            print("VOT group of {:d} videos ({:d} frames): {:.1f}s "
                  "-> {:.1f} fps aggregate".format(
                      b, total, dt, total / max(dt, 1e-9)))
    return records


def load_model(args, device):
    """The model of `args` on `device`, in `--dtype`: `--resume`'s weights
    (a torch state dict or a flax checkpoint), loaded strictly, or (no
    such file) seeded random weights with BN stats calibrated so tracking
    stays finite, as the JAX CLI does."""
    from usot_tpu_torch.models.calibrate import calibrate_batch_stats
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.train.checkpoint import load_model_state

    model = build_usot(mem_size=args.mem_size, width=args.width,
                       channels=args.channels, fused_xcorr=True,
                       dtype=torch.bfloat16 if args.dtype == "bfloat16"
                       else torch.float32)
    if args.resume and os.path.exists(args.resume):
        model.load_state_dict(load_model_state(args.resume))
        return model.to(device).eval()
    print(f"warning: checkpoint {args.resume} not found; random init")
    init_model(model, torch.Generator().manual_seed(0), device=device)
    # fresh BN stats are degenerate (exp overflow in the bbox decode)
    return calibrate_batch_stats(model, n_iter=10)


def main(argv=None, reader=None):
    """Track `--dataset`; `reader(path)` gives a frame's BGR uint8 array
    (default `data.imageio.read_image`: frames held in memory on a
    machine with no image codec)."""
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.tracker.tracker import USOTTracker

    args = parse_args(argv)
    device = resolve_device(args.device)
    f32_numerics()
    if args.arch == OSTRACK:
        if args.engine != "batch" or any(k in args.dataset
                                         for k in ("VOT", "GOT")):
            raise SystemExit(f"--arch {OSTRACK} runs with --engine batch "
                             "and writes OTB-style result files (no VOT "
                             "restarts, no GOT-10k layout)")
        track_dataset_ostrack(load_ostrack(args, device),
                              load_dataset(args.dataset, args.dataset_root),
                              args, reader)
        return
    model = load_model(args, device)
    runner = ModelRunner(model, device=device)
    dataset = load_dataset(args.dataset, args.dataset_root)

    if args.engine == "batch":
        if "VOT" in args.dataset:
            track_dataset_vot_batched(model, runner, dataset, args, reader)
            return
        if "GOT" in args.dataset:
            raise SystemExit("engine=batch writes OTB-style result files; "
                             "use --engine scan for the GOT-10k layout")
        track_dataset_batched(model, runner, dataset, args, reader)
        return

    tracker = USOTTracker()
    engines: dict = {}
    for name in list(dataset.keys()):
        if args.engine == "scan":
            track_video_scan(model, runner, dataset[name], args, engines,
                             reader)
        else:
            track_video(tracker, runner, dataset[name], args, reader)


if __name__ == "__main__":
    main()
