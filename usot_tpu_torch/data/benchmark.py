"""Benchmark video loaders for testing (ref: lib/dataset_loader/benchmark.py).

`load_dataset(name, root)` -> {video: {image_files, gt, name}} for the SOT
benchmark directory/json layouts: OTB*, VOT201x, VOT2020, GOT10K(VAL),
TRACKINGNET, LASOT, DAVIS, YTBVOS, VISDRONE*, RGBT234. `root` defaults to
<repo>/datasets_test like the reference.

The port's own copy of `usot_tpu/data/benchmark.py` (host code, numpy
only); the frames themselves are decoded by `data.imageio.read_image`.
"""
from __future__ import annotations

import glob
import json
import os
from os.path import join

import numpy as np


def default_root() -> str:
    return join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "datasets_test")


def load_dataset(dataset: str, root: str | None = None) -> dict:
    root = root or default_root()
    info: dict = {}

    if "OTB" in dataset:
        base_path = join(root, dataset)
        with open(join(root, dataset + ".json")) as f:
            info = json.load(f)
        for v in info.keys():
            info[v]["image_files"] = [join(base_path, im_f)
                                      for im_f in info[v]["img_names"]]
            info[v]["gt"] = np.array(info[v]["gt_rect"]) - [1, 1, 0, 0]
            info[v]["name"] = info[v]["video_dir"]

    elif "VOT2020" in dataset:
        base_path = join(root, dataset)
        with open(join(base_path, "list.txt")) as f:
            videos = sorted(v.strip() for v in f.readlines())
        for video in videos:
            video_path = join(base_path, video)
            image_files = sorted(glob.glob(join(video_path, "*.jpg")))
            if not image_files:
                image_files = sorted(glob.glob(join(video_path, "color", "*.jpg")))
            with open(join(video_path, "groundtruth.txt")) as f:
                gt = f.readlines()
            info[video] = {"image_files": image_files, "gt": gt, "name": video}

    elif "VOT" in dataset and "RGBT" not in dataset:
        base_path = join(root, dataset)
        with open(join(base_path, "list.txt")) as f:
            videos = sorted(v.strip() for v in f.readlines())
        for video in videos:
            video_path = join(base_path, video)
            image_files = sorted(glob.glob(join(video_path, "*.jpg")))
            if not image_files:
                image_files = sorted(glob.glob(join(video_path, "color", "*.jpg")))
            gt = np.loadtxt(join(video_path, "color", "groundtruth.txt")
                            if os.path.exists(join(video_path, "color",
                                                   "groundtruth.txt"))
                            else join(video_path, "groundtruth.txt"),
                            delimiter=",").astype(np.float64)
            info[video] = {"image_files": image_files, "gt": gt, "name": video}

    elif "GOT10KVAL" in dataset:
        base_path = join(root, dataset)
        videos = sorted(os.listdir(base_path))
        videos.remove("list.txt")
        for video in videos:
            video_path = join(base_path, video)
            image_files = sorted(glob.glob(join(video_path, "*.jpg")))
            gt = np.loadtxt(join(video_path, "groundtruth.txt"), delimiter=",")
            info[video] = {"image_files": image_files, "gt": gt, "name": video}

    elif "GOT10K" in dataset:  # GOT10K TEST: only the first-frame box
        base_path = join(root, dataset)
        videos = sorted(os.listdir(base_path))
        if "list.txt" in videos:
            videos.remove("list.txt")
        for video in videos:
            if "json" in video:
                continue
            video_path = join(base_path, video)
            image_files = sorted(glob.glob(join(video_path, "*.jpg")))
            gt = np.loadtxt(join(video_path, "groundtruth.txt"), delimiter=",")
            info[video] = {"image_files": image_files, "gt": [gt], "name": video}

    elif "TRACKINGNET" in dataset:
        base_path = join(root, dataset)
        seq_path = join(base_path, "frames")
        videos = sorted(v for v in os.listdir(seq_path)
                        if not v.endswith(".json"))
        for video in videos:
            image_files = sorted(glob.glob(join(seq_path, video, "*.jpg")))
            image_files.sort(key=lambda x: int(os.path.basename(x)[:-4]))
            gt = np.loadtxt(join(base_path, "anno", f"{video}.txt"),
                            delimiter=",")
            info[video] = {"image_files": image_files, "gt": [gt], "name": video}

    elif "LASOT" in dataset:
        base_path = join(root, dataset)
        with open(join(root, dataset + ".json")) as f:
            testingvideos = list(json.load(f).keys())
        for f_video in sorted(os.listdir(base_path)):
            if f_video not in testingvideos:
                continue
            f_video_path = join(base_path, f_video)
            gt = np.loadtxt(join(f_video_path, "groundtruth.txt"),
                            delimiter=",") - [1, 1, 0, 0]
            image_files = sorted(glob.glob(join(f_video_path, "img", "*jpg")))
            info[f_video] = {"image_files": image_files, "gt": gt,
                             "name": f_video}

    elif "VISDRONEVAL" in dataset:
        base_path = join(root, dataset)
        seq_path = join(base_path, "sequences")
        for video in sorted(os.listdir(seq_path)):
            image_files = sorted(glob.glob(join(seq_path, video, "*.jpg")))
            gt = np.loadtxt(join(base_path, "annotations", f"{video}.txt"),
                            delimiter=",")
            info[video] = {"image_files": image_files, "gt": gt, "name": video}

    elif "VISDRONETEST" in dataset:
        base_path = join(root, dataset)
        seq_path = join(base_path, "sequences")
        for video in sorted(os.listdir(seq_path)):
            image_files = sorted(glob.glob(join(seq_path, video, "*.jpg")))
            gt = np.loadtxt(join(base_path, "initialization", f"{video}.txt"),
                            delimiter=",").reshape(1, 4)
            info[video] = {"image_files": image_files, "gt": gt, "name": video}

    elif "RGBT234" in dataset:
        base_path = join(root, dataset)
        with open(join(root, dataset + ".json")) as f:
            info = json.load(f)
        for v in info.keys():
            path_name = info[v]["name"]
            info[v]["infrared_imgs"] = [join(base_path, path_name, "infrared", im)
                                        for im in info[v]["infrared_imgs"]]
            info[v]["visiable_imgs"] = [join(base_path, path_name, "visible", im)
                                        for im in info[v]["visiable_imgs"]]
            info[v]["infrared_gt"] = np.array(info[v]["infrared_gt"])
            info[v]["visiable_gt"] = np.array(info[v]["visiable_gt"])
            info[v]["name"] = v

    elif "DAVIS" in dataset and "TEST" not in dataset:
        base_path = join(root, "DAVIS")
        with open(join(base_path, "ImageSets", dataset[-4:], "val.txt")) as f:
            videos = [v.strip() for v in f.readlines()]
        for video in videos:
            info[video] = {
                "anno_files": sorted(glob.glob(
                    join(base_path, "Annotations/480p", video, "*.png"))),
                "image_files": sorted(glob.glob(
                    join(base_path, "JPEGImages/480p", video, "*.jpg"))),
                "name": video,
            }

    elif "YTBVOS" in dataset:
        base_path = join(root, "YTBVOS", "valid")
        with open(join(base_path, "meta.json")) as f:
            meta = json.load(f)["videos"]
        for v in meta.keys():
            objects = meta[v]["objects"]
            frames, anno_frames = [], []
            for obj in objects:
                frames += objects[obj]["frames"]
                anno_frames += [objects[obj]["frames"][0]]
            frames = sorted(np.unique(frames))
            entry = {
                "anno_files": [join(base_path, "Annotations", v, f + ".png")
                               for f in frames],
                "anno_init_files": [join(base_path, "Annotations", v, f + ".png")
                                    for f in anno_frames],
                "image_files": [join(base_path, "JPEGImages", v, f + ".jpg")
                                for f in frames],
                "name": v,
                "start_frame": {}, "end_frame": {},
            }
            for obj in objects:
                entry["start_frame"][obj] = frames.index(objects[obj]["frames"][0])
                entry["end_frame"][obj] = frames.index(objects[obj]["frames"][-1])
            info[v] = entry

    else:
        raise ValueError(f"dataset {dataset} not supported")

    return info
