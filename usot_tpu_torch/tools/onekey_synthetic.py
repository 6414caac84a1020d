"""The one-key chain on synthetic data, the port's counterpart of the
repo's `tools/onekey_synthetic.py`.

    python -m usot_tpu_torch.tools.onekey_synthetic --device cpu \
        [--workdir var/onekey_torch] [--videos 3] [--frames 16] \
        [--samples 8] [--width 8 --channels 32]

Builds raw videos (a moving textured square), an OTB-layout benchmark
and the chain's config (a dict), then drives `usot_tpu_torch.cli.onekey`
through the whole chain: parse_flow (random PWCLite flow -> DP pseudo
boxes -> crop511 + train.json, `--keep_all`) -> train (a naive epoch and
a cycle-memory epoch, checkpoints) -> test_epochs (a benchmark run per
checkpoint) -> evaluate (OPE), and reports the AUC as one JSON line.
Frames are written by `data.imageio.write_image` (OpenCV or Pillow)
unless `build_raw_videos` and `build_benchmark` are given a `writer`.
The config is a dict; `cli.onekey` writes it as YAML (PyYAML) only for
its trainer's subprocess, so the chain through a `run_stage` needs no
PyYAML.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _writer(writer):
    if writer is not None:
        return writer
    from usot_tpu_torch.data.imageio import write_image
    return write_image


def build_raw_videos(root: str, n_videos: int, n_frames: int,
                     h: int = 192, w: int = 256, seed: int = 0,
                     writer=None, ext: str = ".jpg"):
    """`n_videos` videos of a 48-px textured square moving over a noise
    background, `<root>/videoXX/NNNN<ext>`, as the repo's tool draws
    them."""
    write = _writer(writer)
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        vdir = os.path.join(root, f"video{v:02d}")
        os.makedirs(vdir, exist_ok=True)
        bg = (rng.random((h, w, 3)) * 80).astype(np.uint8)
        tex = (rng.random((48, 48, 3)) * 155 + 100).astype(np.uint8)
        x0, y0 = 20 + 10 * v, 30 + 8 * v
        dx, dy = 4 + v, 3
        for f in range(n_frames):
            im = bg.copy()
            x = min(x0 + dx * f, w - 49)
            y = min(y0 + dy * f, h - 49)
            im[y:y + 48, x:x + 48] = tex
            write(os.path.join(vdir, f"{f:04d}{ext}"), im)


def build_benchmark(root: str, n_videos: int = 2, n_frames: int = 8,
                    h: int = 320, w: int = 320, seed: int = 7,
                    writer=None, ext: str = ".jpg"):
    """OTB2015-layout synthetic benchmark: a textured square on noise,
    moving 5 px right and 3 px down a frame (1-indexed xywh ground
    truth)."""
    write = _writer(writer)
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "OTB2015")
    meta = {}
    for v in range(n_videos):
        vid = f"Synth{v}"
        vdir = os.path.join(base, vid, "img")
        os.makedirs(vdir, exist_ok=True)
        tex = (rng.random((48, 48, 3)) * 155 + 100).astype(np.uint8)
        names, gt = [], []
        for f in range(n_frames):
            im = (rng.random((h, w, 3)) * 60).astype(np.uint8)
            cx = min(100 + 5 * f, w - 25)
            cy = min(120 + 3 * f, h - 25)
            im[cy - 24:cy + 24, cx - 24:cx + 24] = tex
            name = f"{f + 1:04d}{ext}"
            write(os.path.join(vdir, name), im)
            names.append(name)
            gt.append([cx - 24 + 1, cy - 24 + 1, 48, 48])
        meta[vid] = {"video_dir": vid, "init_rect": gt[0],
                     "img_names": [f"{vid}/img/{n}" for n in names],
                     "gt_rect": gt, "attr": []}
    with open(os.path.join(root, "OTB2015.json"), "w") as f:
        json.dump(meta, f)


def build_config(workdir: str, samples: int, mem_num: int = 2,
                 width: int | None = None, channels: int | None = None,
                 batch: int = 2) -> dict:
    """The chain's config ({"USOT": {...}}): epoch 5 naive, epoch 6 cycle
    memory and unfrozen, checkpoints of both tested on `bench/` with the
    parity engine. `width`/`channels` set the model's (default the full
    64/256)."""
    prep = os.path.join(workdir, "prep")
    train = {
        "ISTRUE": True,
        "START_EPOCH": 5,   # checkpoints persist from epoch 5
        "END_EPOCH": 6,
        "BATCH": batch,
        "BATCH_STAGE_2": batch,
        "MEMORY_EPOCH": 6,  # epoch 5 naive, epoch 6 cycle-memory
        "UNFIX_EPOCH": 6,
        "MEMORY_NUM": mem_num,
        "PRETRAIN": "nonexistent.model",
        "WHICH_USE": ["GOT10K"],
    }
    if width is not None:
        train["WIDTH"] = width
    if channels is not None:
        train["CHANNELS"] = channels
    return {"USOT": {
        "OUTPUT_DIR": os.path.join(workdir, "log"),
        "CHECKPOINT_DIR": os.path.join(workdir, "snapshot"),
        "WORKERS": 2,
        "PRINT_FREQ": 1,
        "PREPROCESS": {
            "ISTRUE": True,
            "DATA_DIR": os.path.join(workdir, "raw"),
            "OUTPUT_DIR": prep,
            "DATASET": "got10k",
            "KEEP_ALL": True,
            "INSTANCE_SIZE": 511,
        },
        "TRAIN": train,
        "DATASET": {
            "GOT10K": {
                "PATH": os.path.join(prep, "crop511") + "/",
                "ANNOTATION": os.path.join(prep, "train.json"),
                "USE": samples,
            },
        },
        "TEST": {
            "ISTRUE": True,
            "DATA": "OTB2015",
            "START_EPOCH": 5,
            "END_EPOCH": 6,
            "DATASET_ROOT": os.path.join(workdir, "bench"),
            "RESULT_DIR": os.path.join(workdir, "result"),
            "ENGINE": "parity",
            "MEM_SIZE": mem_num,
        },
    }}


def summarize(workdir: str) -> dict:
    """AUC per tracker of the chain's results (OPE recomputed in this
    process) and the stages' seconds."""
    from usot_tpu_torch.cli.evaluate import evaluate

    result_root = os.path.join(workdir, "result", "OTB2015")
    trackers = sorted(os.listdir(result_root))
    out = evaluate("OTB2015", os.path.join(workdir, "bench"), result_root,
                   trackers)
    aucs = {t: float(np.mean([np.mean(v) for v in
                              out["success"][t].values()]))
            for t in trackers}
    stages = {}
    stage_path = os.path.join(workdir, "log", "onekey_stages.json")
    if os.path.exists(stage_path):
        with open(stage_path) as f:
            stages = json.load(f)
    summary = {"trackers": trackers, "auc": aucs,
               "max_auc": max(aucs.values()), "stage_seconds": stages}
    with open(os.path.join(workdir, "onekey_result.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def run(workdir: str, n_videos: int = 3, n_frames: int = 16,
        samples: int = 8, device=None, width=None, channels=None) -> dict:
    """The chain on fresh synthetic data under `workdir`, each stage a
    subprocess; returns `summarize`'s record."""
    from usot_tpu_torch.cli.onekey import main as onekey_main

    os.makedirs(workdir, exist_ok=True)
    build_raw_videos(os.path.join(workdir, "raw"), n_videos, n_frames)
    build_benchmark(os.path.join(workdir, "bench"))
    cfg = build_config(workdir, samples, width=width, channels=channels)
    argv = [] if device is None else ["--device", str(device)]
    onekey_main(argv, cfg=cfg)
    return summarize(workdir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="var/onekey_torch")
    ap.add_argument("--videos", type=int, default=3)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    summary = run(a.workdir, a.videos, a.frames, a.samples, a.device,
                  a.width, a.channels)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
