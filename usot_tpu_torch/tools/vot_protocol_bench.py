"""The batched VOT restart protocol at benchmark scale, on one card: the
port's counterpart of the repo's `tools/vot_protocol_bench.py`.

    python -m usot_tpu_torch.tools.vot_protocol_bench [--videos 60]
        [--min-frames 300] [--max-frames 1500] [--h 360] [--w 480]
        [--chunk 32] [--batch 8] [--ckpt <.pth>] [--skip-scan]
        [--width N] [--channels N] [--device cpu] [--out <json>]

The benchmark is the repo tool's `gen_benchmark` (the same seed, the same
rng draws in the same order, the same ground truth and `meta`): a
VOT2018-shaped set of videos whose targets move smoothly between scene
cuts where they teleport (and sometimes resize), so that a tracker that
holds its target between cuts loses it at cuts and the restart protocol
(failure -> 5-frame skip -> re-init; ref: scripts/test_usot.py:85-103)
fires on its own. Video 0, "spill", shrinks its target across its first
cut so that the re-init flips the big/small search size and the batched
engine hands the video to the scan engine; every 7th target is small.

The frames are not written: the repo tool writes JPEGs (quality 85) with
OpenCV, which the card's machine lacks, and 60 videos at 360x480 are
~11 GB as arrays. Each video keeps its background and each frame its
box and colour; `reader(path)` renders frame f on demand, and the frame
paths are the repo tool's file names. The pixels are the arrays the repo
tool hands to `cv2.imwrite`, not their JPEG round trip.

Both engines run in this process through the test CLI's own functions
(`usot_tpu_torch/cli/test.py`): `track_dataset_vot_batched` for
`--engine batch` (`--batch` lanes, `--chunk` frames per chunk) and
`track_video_scan` per video for `--engine scan`, each writing the CLI's
result layout under `--root`. Recorded per engine: the wall seconds and
the seconds of tracking alone (the model built and its weights loaded
apart), aggregate frames/s over both, restarts, the videos spilled
(`spilled`, from the CLI's records of `spill_from`) and K1's launches;
then the repo tool's `compare_results` of the two engines' result
files, and the card's name and power limit. `--ckpt` defaults to
`regen_bench_ckpt`'s checkpoint (a missing file means calibrated random
weights, as in the CLI). Writes `--out`. Runs on the GPU unless
`--device cpu` is given. The tool turns TF32 off itself
(`core.device.f32_numerics`), since it calls the CLI's functions and
not its `main`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch

DEFAULT_CKPT = "var/full_schedule_torch/unbroken/snapshot/checkpoint_e30.pth"
DATASET = "VOT2018"


def gen_benchmark(n_videos: int, min_frames: int, max_frames: int, h: int,
                  w: int, seed: int = 0):
    """The repo tool's benchmark, held as draws rather than files.
    Returns (videos, meta): per video its name, background, per-frame
    boxes (x1, y1, side) and colours, and its ground-truth polygons."""
    rng = np.random.default_rng(seed)
    videos, total_frames, total_cuts = [], 0, 0
    # area threshold for the big/small search choice is 0.004 of the
    # frame (lib/tracker/usot_tracker.py:44-49): targets above it get
    # instance 255, below it 271
    thresh_side = float(np.sqrt(0.004 * h * w))

    for vi in range(n_videos):
        name = "spill" if vi == 0 else f"vid{vi:03d}"
        n = int(rng.integers(min_frames, max_frames + 1))
        total_frames += n

        bg = (rng.random((h, w, 3)) * 200).astype(np.uint8)
        color = rng.integers(60, 255, 3)
        # most targets comfortably above the threshold (small_sz group),
        # every 7th below it (big_sz group) so both engines exist
        if vi % 7 == 3:
            size = float(rng.uniform(0.45, 0.75) * thresh_side)
        else:
            size = float(rng.uniform(1.4, 3.0) * thresh_side)
        # scene cuts: teleport + occasional resize, every ~120-300 frames
        cuts = []
        f = int(rng.integers(120, 300))
        while f < n - 30:
            cuts.append(f)
            f += int(rng.integers(120, 300))
        if vi == 0:
            # the spill video: guarantee one cut that shrinks the target
            # below the threshold, so the re-init flips the instance size
            cuts = cuts or [min(150, n - 30)]
        total_cuts += len(cuts)

        margin = size / 2 + 4
        cx = float(rng.uniform(margin, w - margin))
        cy = float(rng.uniform(margin, h - margin))
        vel = rng.uniform(-1.5, 1.5, 2)
        gts, boxes, colours = [], [], []
        cut_i = 0
        for fi in range(n):
            if cut_i < len(cuts) and fi == cuts[cut_i]:
                if vi == 0 and cut_i == 0:
                    size = float(0.55 * thresh_side)  # flips to big_sz
                elif rng.random() < 0.3:
                    size = float(np.clip(size * rng.uniform(0.7, 1.4),
                                         12, min(h, w) / 3))
                margin = size / 2 + 4
                # teleport far enough that the old search window
                # can't see the new location
                for _ in range(50):
                    nx = float(rng.uniform(margin, w - margin))
                    ny = float(rng.uniform(margin, h - margin))
                    if abs(nx - cx) + abs(ny - cy) > 0.6 * min(h, w):
                        break
                cx, cy = nx, ny
                vel = rng.uniform(-1.5, 1.5, 2)
                cut_i += 1
            else:
                cx += float(vel[0]) + 0.4 * np.sin(fi / 17.0)
                cy += float(vel[1]) + 0.4 * np.cos(fi / 23.0)
                margin = size / 2 + 4
                if not (margin <= cx <= w - margin):
                    vel[0] = -vel[0]
                    cx = float(np.clip(cx, margin, w - margin))
                if not (margin <= cy <= h - margin):
                    vel[1] = -vel[1]
                    cy = float(np.clip(cy, margin, h - margin))

            jit = rng.integers(-10, 10, 3)
            colours.append(np.clip(color + jit, 0, 255))
            boxes.append((int(cx - size / 2), int(cy - size / 2), int(size)))
            x0, x1f = cx - size / 2, cx + size / 2
            y0, y1f = cy - size / 2, cy + size / 2
            gts.append([x0, y0, x1f, y0, x1f, y1f, x0, y1f])
        videos.append(dict(name=name, n=n, bg=bg, boxes=boxes,
                           colours=colours, gts=gts))
    meta = {"videos": n_videos, "total_frames": total_frames,
            "cuts": total_cuts, "h": h, "w": w}
    return videos, meta


def render(video: dict, fi: int) -> np.ndarray:
    """Frame `fi` of `video`: the array the repo tool writes as a JPEG."""
    im = video["bg"].copy()
    x1, y1, s = video["boxes"][fi]
    im[max(0, y1):y1 + s, max(0, x1):x1 + s] = video["colours"][fi]
    return im


def groundtruth_text(video: dict) -> str:
    """The repo tool's `groundtruth.txt` of `video`."""
    return "".join(",".join(f"{v:.4f}" for v in g) + "\n"
                   for g in video["gts"])


def frame_path(root: str, name: str, fi: int) -> str:
    return os.path.join(root, DATASET, name, f"{fi + 1:08d}.jpg")


def dataset_and_reader(videos, root: str):
    """The dict `data.benchmark.load_dataset` gives for the repo tool's
    files under `root` (videos in sorted order, `gt` as `np.loadtxt`
    parses the written text), and `reader(path)`, which renders the
    frame the repo tool writes at `path` (None for any other path)."""
    dataset, frames = {}, {}
    for v in sorted(videos, key=lambda v: v["name"]):
        name = v["name"]
        gt = np.array([[float(x) for x in line.split(",")] for line in
                       groundtruth_text(v).splitlines()], np.float64)
        paths = [frame_path(root, name, fi) for fi in range(v["n"])]
        frames.update((os.path.normpath(p), (v, fi))
                      for fi, p in enumerate(paths))
        dataset[name] = {"name": name, "gt": gt, "image_files": paths}

    def reader(path):
        hit = frames.get(os.path.normpath(str(path)))
        return None if hit is None else render(*hit)

    return dataset, reader


def run_engine(engine: str, dataset, reader, result_dir: str, args):
    """One engine over the benchmark through the test CLI's functions.
    Returns (record, the CLI's per-group records)."""
    from usot_tpu_torch.cli import test as cli
    from usot_tpu_torch.core.device import resolve_device
    from usot_tpu_torch.ops.xcorr_kernel import launch_counts
    from usot_tpu_torch.tracker.runner import ModelRunner

    argv = ["--dataset", DATASET, "--engine", engine, "--resume", args.ckpt,
            "--result_dir", result_dir, "--chunk", str(args.chunk),
            "--batch", str(args.batch)]
    if args.width is not None:
        argv += ["--width", str(args.width)]
    if args.channels is not None:
        argv += ["--channels", str(args.channels)]
    if args.device:
        argv += ["--device", args.device]
    cargs = cli.parse_args(argv)
    print("==> cli.test", " ".join(argv), flush=True)
    device = resolve_device(cargs.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    model = cli.load_model(cargs, device)
    runner = ModelRunner(model, device=device)
    sync()
    t1 = time.perf_counter()
    k1 = launch_counts()["K1"]
    groups = []
    if engine == "batch":
        groups = cli.track_dataset_vot_batched(model, runner, dataset,
                                               cargs, reader)
    else:
        engines: dict = {}
        for name in dataset:
            cli.track_video_scan(model, runner, dataset[name], cargs,
                                 engines, reader)
    sync()
    t2 = time.perf_counter()
    rec = {"wall_s": t2 - t0, "track_s": t2 - t1,
           "spilled": [n for g in groups for n in g["spilled"]],
           "k1_launches": launch_counts()["K1"] - k1}
    if groups:
        rec["replays"] = sum(g.get("replays", 0) for g in groups)
        rec["chunks"] = sum(g.get("chunks", 0) for g in groups)
    return rec, groups


def read_results(result_dir: str):
    base = os.path.join(result_dir, DATASET, "USOT", "baseline")
    out = {}
    for name in sorted(os.listdir(base)):
        path = os.path.join(base, name, name + "_001.txt")
        rows = []
        with open(path) as f:
            for ln in f:
                parts = ln.strip().split(",")
                rows.append(int(float(parts[0])) if len(parts) == 1
                            else [float(v) for v in parts])
        out[name] = rows
    return out


def skeleton(rows):
    return [r if isinstance(r, int) else "b" for r in rows]


def compare_results(a, b):
    """Characterize batch-vs-scan agreement (the repo tool's summary).

    Lockstep batching changes f32 reduction order, so per-step deltas are
    ~1e-4 px (tests/test_lockstep.py); over hundreds of frames near a
    LOST target (response-map argmax near ties) the deltas amplify
    chaotically and a marginal overlap check can flip a failure by a few
    frames, after which the two trajectories legitimately diverge
    (different re-init frame). The summary separates the two regimes:
    identical-skeleton prefix fraction + per-frame delta percentiles
    within it, and per-video divergence points (each after N identical
    restarts) outside it."""
    assert sorted(a) == sorted(b)
    mism, deltas, ident_frames, total_frames = [], [], 0, 0
    for name in sorted(a):
        sa, sb = skeleton(a[name]), skeleton(b[name])
        n = len(sa)
        total_frames += n
        if sa != sb:
            f = next(i for i, (x, y) in enumerate(zip(sa, sb)) if x != y)
            ident_frames += f
            mism.append({
                "video": name, "first_mismatch_frame": f, "frames": n,
                "identical_restarts_before": sum(
                    1 for r in a[name][:f] if r == 2)})
            continue
        ident_frames += n
        for ra, rb in zip(a[name], b[name]):
            if not isinstance(ra, int):
                deltas.append(float(np.max(np.abs(
                    np.asarray(ra) - np.asarray(rb)))))
    d = np.asarray(deltas) if deltas else np.zeros(1)
    pct = np.percentile(d, [50, 90, 99])
    summary = {
        "skeleton_identical_videos": len(a) - len(mism),
        "videos": len(a),
        "identical_prefix_frames_pct": round(100 * ident_frames
                                             / total_frames, 2),
        "skeleton_divergences": mism,
        "bbox_delta_px_on_identical_skeletons": {
            "median": round(float(pct[0]), 5),
            "p90": round(float(pct[1]), 5),
            "p99": round(float(pct[2]), 4),
            "max": round(float(d.max()), 4),
            "frames_over_1px": int((d > 1).sum()),
            "frames": len(deltas),
        },
    }
    print(f"compare: skeletons identical in "
          f"{summary['skeleton_identical_videos']}/{len(a)} videos "
          f"({summary['identical_prefix_frames_pct']}% of frames in "
          f"identical prefixes); bbox delta median "
          f"{pct[0]:.5f} px, p90 {pct[1]:.5f}, max {d.max():.2f}",
          flush=True)
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="var/vot_bench_torch",
                    help="result files of both engines")
    ap.add_argument("--videos", type=int, default=60)
    ap.add_argument("--min-frames", type=int, default=300)
    ap.add_argument("--max-frames", type=int, default=1500)
    ap.add_argument("--h", type=int, default=360)
    ap.add_argument("--w", type=int, default=480)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--out", default="chiprun_out/votbench_torch.json")
    ap.add_argument("--skip-scan", action="store_true",
                    help="only run the batched engine (no file compare)")
    ap.add_argument("--width", type=int, default=None,
                    help="model width override (e.g. 8 for the committed "
                         "tiny fixture)")
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                    "one). `cpu` runs on the CPU")
    return ap.parse_args(argv)


def run(args):
    """Generate, run the engines, compare. Returns the record (with each
    engine's parsed result rows under `"results"`)."""
    from usot_tpu_torch.core.device import f32_numerics, resolve_device

    device = resolve_device(args.device)  # raises before any work
    f32_numerics()  # the engines call the CLI's functions, not its main
    t0 = time.perf_counter()
    videos, meta = gen_benchmark(args.videos, args.min_frames,
                                 args.max_frames, args.h, args.w)
    dataset, reader = dataset_and_reader(videos, args.root)
    gen_s = time.perf_counter() - t0
    print(f"benchmark: {meta} (generated in {gen_s:.1f}s)", flush=True)
    engines = ["batch"] if args.skip_scan else ["batch", "scan"]
    out = {"what": "benchmark-scale batched VOT restart protocol "
                   "(ref: scripts/test_usot.py:85-103)",
           "benchmark": meta, "generate_s": gen_s,
           "checkpoint": args.ckpt, "chunk": args.chunk,
           "lanes": args.batch, "device": str(device), "results": {}}
    if os.path.exists(args.ckpt):
        from usot_tpu_torch.tools.bench import sha256

        out["checkpoint_sha256"] = sha256(args.ckpt)
    for engine in engines:
        rdir = os.path.join(args.root, f"result_{engine}")
        shutil.rmtree(rdir, ignore_errors=True)  # the CLI keeps results
        rec, groups = run_engine(engine, dataset, reader, rdir, args)
        results = read_results(rdir)
        total = sum(len(rows) for rows in results.values())
        rec.update(restarts=sum(sum(1 for r in rows if r == 2)
                                for rows in results.values()),
                   total_frames=total, fps=total / rec["wall_s"],
                   track_fps=total / rec["track_s"])
        out[engine] = rec
        out["results"][engine] = results
        print(f"{engine}: {total} frames in {rec['wall_s']:.1f}s = "
              f"{rec['fps']:.1f} fps aggregate ({rec['track_fps']:.1f} "
              f"tracking alone), {rec['restarts']} organic restarts, "
              f"{len(rec['spilled'])} instance spills", flush=True)
    if not args.skip_scan:
        out["compare"] = compare_results(out["results"]["batch"],
                                         out["results"]["scan"])
    if device.type == "cuda":
        from usot_tpu_torch.tools.timing import card_line

        out["card"] = card_line()
    return out


def main(argv=None):
    args = parse_args(argv)
    out = run(args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({k: v for k, v in out.items() if k != "results"}, f,
                  indent=1)
    print("wrote", args.out, flush=True)
    return out


if __name__ == "__main__":
    main()
