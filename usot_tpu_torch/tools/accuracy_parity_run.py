"""Accuracy end to end on trained weights: the batch engine against the
parity tracker on a synthetic OTB-style benchmark, through the real test
CLI, its result files and the OPE evaluation. The port's counterpart of
the repo's `tools/accuracy_parity_run.py`.

    python -m usot_tpu_torch.tools.accuracy_parity_run [--videos 6]
        [--frames 40] [--ckpt <.pth>] [--device cpu] [--json PATH]

The benchmark is the repo tool's (the same draws in the same order:
`default_rng(7)`, `--videos` videos of `--frames` frames at 360x360, a
coloured square moving over noise); its frames stay in memory and reach
`cli.test.main(argv, reader)` through a reader, so no image codec is
needed. Runs, each scored by `cli.evaluate.evaluate`:
  - the parity tracker in float32 (the reference's host loop);
  - the batch engine (`--batch` = every video) in float32, which
    separates the engine's own gap from bf16's;
  - the batch engine in bfloat16, the repo tool's comparison;
  - the parity tracker on calibrated random weights (no `--resume`
    file), the floor that training must beat.
`--ckpt` defaults to `regen_bench_ckpt`'s checkpoint. Prints AUC and
precision@20 of each run and the gaps to the parity tracker; `run`
returns them as a dict.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

DEFAULT_CKPT = "var/full_schedule_torch/unbroken/snapshot/checkpoint_e30.pth"
# (engine, dtype, result tag, trained weights)
RUNS = (("parity", "float32", "USOT_parity", True),
        ("batch", "float32", "USOT_batch_f32", True),
        ("batch", "bfloat16", "USOT_batch_bf16", True),
        ("parity", "float32", "USOT_random", False))


def build_benchmark(root, n_videos, n_frames, size=360):
    """`<root>/OTB2015.json` for `n_videos` synthetic videos; returns
    `reader(path)`, the frame the repo tool writes at `path` (BGR uint8;
    None for any other path)."""
    base = os.path.join(root, "OTB2015")
    rng = np.random.default_rng(7)
    meta, frames = {}, {}
    for v in range(n_videos):
        vid = f"Syn{v:02d}"
        vdir = os.path.join(base, vid, "img")
        noise = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        color = rng.integers(80, 255, 3).tolist()
        box = int(rng.integers(36, 64))
        x0, y0 = rng.integers(80, 140, 2)
        vx, vy = rng.uniform(1.0, 4.0, 2)
        names, gt = [], []
        for f in range(n_frames):
            im = noise.copy()
            cx = int(x0 + vx * f)
            cy = int(y0 + vy * f)
            im[cy - box // 2:cy + box // 2,
               cx - box // 2:cx + box // 2] = color
            name = f"{f + 1:04d}.jpg"
            frames[os.path.normpath(os.path.join(vdir, name))] = im
            names.append(name)
            gt.append([cx - box // 2, cy - box // 2, box, box])
        meta[vid] = {"video_dir": vid, "init_rect": gt[0],
                     "img_names": [f"{vid}/img/{n}" for n in names],
                     "gt_rect": gt, "attr": []}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "OTB2015.json"), "w") as f:
        json.dump(meta, f)

    def reader(path):
        return frames.get(os.path.normpath(str(path)))

    return reader


def score(root, tag, n_videos):
    """OPE of one run's result files: (AUC, precision@20), the repo
    tool's means over the videos. Raises unless every video is scored."""
    from usot_tpu_torch.cli.evaluate import evaluate

    out = evaluate("OTB2015", root, os.path.join(root, "result", "OTB2015"),
                   [tag])
    if len(out["success"][tag]) != n_videos:
        raise RuntimeError(f"{tag}: {len(out['success'][tag])} of "
                           f"{n_videos} videos scored")
    auc = float(np.mean(list(out["success"][tag].values())))
    prec = float(np.mean(list(out["precision"][tag].values()), axis=0)[20])
    return auc, prec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=6)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--root", default="var/parity_bench_torch")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--mem_size", type=int, default=4,
                    help="the memory queue's length (the test CLI's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--json", default=None,
                    help="write the returned record to this path")
    return ap.parse_args(argv)


def run(args):
    """The four runs on a fresh benchmark under `--root`. Returns
    {tag: {"auc", "precision20"}} and the gaps to the parity tracker
    (`delta_<tag>`: |dAUC|, |dprecision@20|)."""
    from usot_tpu_torch.cli.test import main as test_main
    from usot_tpu_torch.core.device import resolve_device

    resolve_device(args.device)  # raises before any work without a GPU
    if not os.path.exists(args.ckpt):
        raise FileNotFoundError(f"--ckpt {args.ckpt}")
    shutil.rmtree(os.path.join(args.root, "result"), ignore_errors=True)
    reader = build_benchmark(args.root, args.videos, args.frames)
    results = {}
    for engine, dtype, tag, trained in RUNS:
        argv = ["--dataset", "OTB2015", "--dataset_root", args.root,
                "--resume", args.ckpt if trained else
                os.path.join(args.root, "no_such_checkpoint.pth"),
                "--engine", engine, "--dtype", dtype,
                "--batch", str(args.videos), "--arch", tag,
                "--width", str(args.width), "--channels", str(args.channels),
                "--mem_size", str(args.mem_size),
                "--result_dir", os.path.join(args.root, "result")]
        if args.device:
            argv += ["--device", args.device]
        test_main(argv, reader)
        auc, prec = score(args.root, tag, args.videos)
        results[tag] = {"auc": auc, "precision20": prec}
        print(f"{tag}: AUC {auc:.4f}  precision@20 {prec:.4f}", flush=True)
    ref = results["USOT_parity"]
    for tag in ("USOT_batch_f32", "USOT_batch_bf16"):
        r = results[tag]
        results[f"delta_{tag}"] = {
            "auc": abs(ref["auc"] - r["auc"]),
            "precision20": abs(ref["precision20"] - r["precision20"])}
        print(f"delta {tag}: AUC {results[f'delta_{tag}']['auc']:.4f}  "
              f"precision {results[f'delta_{tag}']['precision20']:.4f}",
              flush=True)
    return results


def main(argv=None):
    args = parse_args(argv)
    rec = run(args)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
