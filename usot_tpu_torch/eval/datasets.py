"""Eval-side dataset wrappers (ref: lib/eval_toolkit/pysot/datasets/).

Video objects carry the gt trajectory, image list and per-tracker result
loading; VOT videos also carry per-frame attribute tags used by EAO.

The port's own copy of `usot_tpu/eval/datasets.py`. A video's frame size
(the overlap bounds of the VOT and F1 statistics) is read from its first
frame's header, PNG `IHDR` or JPEG `SOFn`, which is all that
`PIL.Image.open(path).size` reads: no image library is needed.
"""
from __future__ import annotations

import json
import os
import struct
from glob import glob

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# JPEG start-of-frame markers: C0-CF but DHT (C4), JPG (C8) and DAC (CC)
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
             0xCD, 0xCE, 0xCF}


def _jpeg_size(f, path):
    """(w, h) of the first SOFn segment after SOI."""
    while True:
        byte = f.read(1)
        while byte and byte != b"\xff":  # skip to a marker
            byte = f.read(1)
        while byte == b"\xff":  # fill bytes
            byte = f.read(1)
        if not byte:
            break
        marker = byte[0]
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # no length field
            continue
        if marker in (0xD9, 0xDA):  # EOI, SOS: no frame header before
            break
        seg = f.read(2)
        if len(seg) < 2:
            break
        (length,) = struct.unpack(">H", seg)
        if marker in _JPEG_SOF:
            body = f.read(5)
            if len(body) < 5:
                break
            h, w = struct.unpack(">xHH", body)
            return w, h
        f.seek(length - 2, os.SEEK_CUR)
    raise ValueError(f"{path}: JPEG without a frame header (SOFn)")


def _image_size(path):
    """(w, h) of a PNG or JPEG file from its header; raises, naming the
    file, for any other format."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == _PNG_SIGNATURE and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            return _jpeg_size(f, path)
    raise ValueError(f"{path}: not a PNG or JPEG file; the frame size is "
                     "read from a PNG or JPEG header")


class Video:
    def __init__(self, name, root, video_dir, init_rect, img_names, gt_rect,
                 attr, load_img=False):
        self.name = name
        self.video_dir = video_dir
        self.init_rect = init_rect
        self.gt_traj = gt_rect
        self.attr = attr
        self.pred_trajs = {}
        self.img_names = [os.path.join(root, x) for x in img_names]
        self.imgs = None
        if self.img_names and os.path.exists(self.img_names[0]):
            self.width, self.height = _image_size(self.img_names[0])
        else:
            self.width = self.height = 0

    def __len__(self):
        return len(self.img_names)

    def load_tracker(self, path, tracker_names=None, store=True):
        if not tracker_names:
            tracker_names = [x.split("/")[-1] for x in glob(path)
                             if os.path.isdir(x)]
        if isinstance(tracker_names, str):
            tracker_names = [tracker_names]
        for name in tracker_names:
            traj_file = os.path.join(path, name, self.name + ".txt")
            if os.path.exists(traj_file):
                with open(traj_file) as f:
                    pred_traj = [list(map(float, x.strip().split(",")))
                                 for x in f.readlines()]
                if store:
                    self.pred_trajs[name] = pred_traj
                else:
                    return pred_traj
        self.tracker_names = list(self.pred_trajs.keys())


class OTBVideo(Video):
    pass


class LaSOTVideo(Video):
    def __init__(self, name, root, video_dir, init_rect, img_names, gt_rect,
                 attr, absent, load_img=False):
        super().__init__(name, root, video_dir, init_rect, img_names,
                         gt_rect, attr, load_img)
        self.absent = np.array(absent, np.int8)


class VOTVideo(Video):
    def __init__(self, name, root, video_dir, init_rect, img_names, gt_rect,
                 camera_motion, illum_change, motion_change, size_change,
                 occlusion, load_img=False):
        super().__init__(name, root, video_dir, init_rect, img_names,
                         gt_rect, None, load_img)
        self.tags = {"all": [1] * len(gt_rect)}
        self.tags["camera_motion"] = camera_motion
        self.tags["illum_change"] = illum_change
        self.tags["motion_change"] = motion_change
        self.tags["size_change"] = size_change
        self.tags["occlusion"] = occlusion
        all_tag = [v for v in self.tags.values() if len(v) > 0]
        self.tags["empty"] = np.all(
            1 - np.array(all_tag), axis=1).astype(np.int32).tolist()
        self.tag_names = list(self.tags.keys())

    def select_tag(self, tag, start=0, end=0):
        if tag == "empty":
            return self.tags[tag]
        return self.tags[tag][start:end]

    def load_tracker(self, path, tracker_names=None, store=True):
        if not tracker_names:
            tracker_names = [x.split("/")[-1] for x in glob(path)
                             if os.path.isdir(x)]
        if isinstance(tracker_names, str):
            tracker_names = [tracker_names]
        for name in tracker_names:
            traj_files = glob(os.path.join(path, name, "baseline", self.name,
                                           "*0*.txt"))
            if len(traj_files) != 15:
                traj_files = traj_files[0:1]
            pred_traj = []
            for traj_file in traj_files:
                with open(traj_file) as f:
                    traj = [list(map(float, x.strip().split(",")))
                            for x in f.readlines()]
                    pred_traj.append(traj)
            if store:
                self.pred_trajs[name] = pred_traj
            else:
                return pred_traj


class BaseDataset:
    def __init__(self, name, dataset_root):
        self.name = name
        self.dataset_root = dataset_root
        self.videos: dict = {}

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self.videos[idx]
        return self.videos[sorted(self.videos.keys())[idx]]

    def __len__(self):
        return len(self.videos)

    def __iter__(self):
        for k in sorted(self.videos.keys()):
            yield self.videos[k]

    def set_tracker(self, path, tracker_names):
        self.tracker_path = path
        self.tracker_names = tracker_names


def _build_attr(videos) -> dict:
    """Attribute -> [video names] grouping, 'ALL' first
    (ref: pysot/datasets/otb.py:103-115)."""
    attr = {"ALL": list(videos.keys())}
    for name, v in videos.items():
        for a in (v.attr or []):
            attr.setdefault(a, []).append(name)
    return attr


class OTBDataset(BaseDataset):
    def __init__(self, name, dataset_root, load_img=False):
        super().__init__(name, dataset_root)
        with open(os.path.join(dataset_root, name + ".json")) as f:
            meta = json.load(f)
        for video in meta.keys():
            self.videos[video] = OTBVideo(
                video, os.path.join(dataset_root, name),
                meta[video]["video_dir"], meta[video]["init_rect"],
                meta[video]["img_names"], meta[video]["gt_rect"],
                meta[video].get("attr"), load_img)
        self.attr = _build_attr(self.videos)


class LaSOTDataset(BaseDataset):
    def __init__(self, name, dataset_root, load_img=False):
        super().__init__(name, dataset_root)
        with open(os.path.join(dataset_root, name + ".json")) as f:
            meta = json.load(f)
        for video in meta.keys():
            self.videos[video] = LaSOTVideo(
                video, os.path.join(dataset_root, name),
                meta[video]["video_dir"], meta[video]["init_rect"],
                meta[video]["img_names"], meta[video]["gt_rect"],
                meta[video].get("attr"), meta[video]["absent"], load_img)
        self.attr = _build_attr(self.videos)


class UAVDataset(OTBDataset):
    pass


class NFSDataset(OTBDataset):
    pass


class GOT10kDataset(BaseDataset):
    """GOT-10k eval-side wrapper (ref: pysot/datasets/got10k.py:51-76).
    Images resolve against the dataset root itself; only the 'ALL'
    attribute group exists."""

    def __init__(self, name, dataset_root, load_img=False):
        super().__init__(name, dataset_root)
        with open(os.path.join(dataset_root, name + ".json")) as f:
            meta = json.load(f)
        for video in meta.keys():
            self.videos[video] = Video(
                video, dataset_root,
                meta[video]["video_dir"], meta[video]["init_rect"],
                meta[video]["img_names"], meta[video]["gt_rect"],
                None, load_img)
        self.attr = {"ALL": list(self.videos.keys())}


class TrackingNetDataset(GOT10kDataset):
    """TrackingNet eval-side wrapper (ref: pysot/datasets/trackingnet.py:
    51-75 — structurally identical to the GOT-10k one)."""


class VOTDataset(BaseDataset):
    def __init__(self, name, dataset_root, load_img=False):
        super().__init__(name, dataset_root)
        with open(os.path.join(dataset_root, name + ".json")) as f:
            meta = json.load(f)
        for video in meta.keys():
            self.videos[video] = VOTVideo(
                video, os.path.join(dataset_root, name),
                meta[video]["video_dir"], meta[video]["init_rect"],
                meta[video]["img_names"], meta[video]["gt_rect"],
                meta[video]["camera_motion"], meta[video]["illum_change"],
                meta[video]["motion_change"], meta[video]["size_change"],
                meta[video]["occlusion"], load_img)
        self.tags = ["all", "camera_motion", "illum_change", "motion_change",
                     "size_change", "occlusion", "empty"]


class VOTLTVideo(Video):
    """VOT long-term video: results live under longterm/<video>/ with a
    per-frame confidence file (ref: pysot/datasets/vot.py VOTLTVideo)."""

    def __init__(self, name, root, video_dir, init_rect, img_names, gt_rect,
                 load_img=False):
        super().__init__(name, root, video_dir, init_rect, img_names,
                         gt_rect, None, load_img)
        self.gt_traj = [[0] if np.isnan(bbox[0]) else bbox
                        for bbox in self.gt_traj]
        self.confidence = {}

    def load_tracker(self, path, tracker_names=None, store=True):
        if not tracker_names:
            tracker_names = [x.split("/")[-1] for x in glob(path)
                             if os.path.isdir(x)]
        if isinstance(tracker_names, str):
            tracker_names = [tracker_names]
        traj, score = None, None
        for name in tracker_names:
            traj_file = os.path.join(path, name, "longterm", self.name,
                                     self.name + "_001.txt")
            with open(traj_file) as f:
                traj = [list(map(float, x.strip().split(",")))
                        for x in f.readlines()]
            if store:
                self.pred_trajs[name] = traj
            confidence_file = os.path.join(
                path, name, "longterm", self.name,
                self.name + "_001_confidence.value")
            with open(confidence_file) as f:
                score = [float(x.strip()) for x in f.readlines()[1:]]
                score.insert(0, float("nan"))
            if store:
                self.confidence[name] = score
        return traj, score


class VOTLTDataset(BaseDataset):
    """VOT long-term: confidence files alongside bbox files."""

    def __init__(self, name, dataset_root, load_img=False):
        super().__init__(name, dataset_root)
        with open(os.path.join(dataset_root, name + ".json")) as f:
            meta = json.load(f)
        for video in meta.keys():
            self.videos[video] = VOTLTVideo(
                video, os.path.join(dataset_root, name),
                meta[video]["video_dir"], meta[video]["init_rect"],
                meta[video]["img_names"], meta[video]["gt_rect"], load_img)


def create_dataset(name: str, dataset_root: str, load_img=False):
    if "OTB" in name:
        return OTBDataset(name, dataset_root, load_img)
    if "LASOT" in name.upper():
        return LaSOTDataset(name, dataset_root, load_img)
    if "UAV" in name:
        return UAVDataset(name, dataset_root, load_img)
    if "NFS" in name:
        return NFSDataset(name, dataset_root, load_img)
    if "VOT" in name and "LT" in name:
        return VOTLTDataset(name, dataset_root, load_img)
    if "VOT" in name:
        return VOTDataset(name, dataset_root, load_img)
    if "GOT" in name.upper():
        return GOT10kDataset(name, dataset_root, load_img)
    if "TRACKINGNET" in name.upper():
        return TrackingNetDataset(name, dataset_root, load_img)
    raise ValueError(f"unknown dataset {name}")
