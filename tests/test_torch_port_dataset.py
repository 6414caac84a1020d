"""The port's live data pipeline (`usot_tpu_torch.data.{dataset,loader}`,
`usot_tpu_torch.cli.make_shards`) against `usot_tpu`'s on a crop511
JPEG fixture like `tests/test_data.py:16-48`, decoded by cv2 on both
sides: the same config, seed and index give the same sample.

Labels are equal, boxes within 1e-5 px, images within one grey level on
all but 0.1 % of their pixels: the crop is one grey level from cv2's on
~0.02 % of pixels (`test_torch_port_augment.py`), and cv2's own HSV round
trip in the search and memory pipelines can take such a pixel several
levels away (measured: at most 0.007 % of an image's pixels).
"""
import json
import os
import sys

import cv2
import numpy as np
import pytest

from usot_tpu.config.defaults import default_config
from usot_tpu.data.dataset import SubDataset as JaxSubDataset
from usot_tpu.data.dataset import USOTDataset as JaxDataset
from usot_tpu_torch.config.defaults import load_config
from usot_tpu_torch.data.dataset import SubDataset, USOTDataset
from usot_tpu_torch.data.loader import DataLoader, collate

IMAGES = ("template", "search", "search_memory")
EXACT = ("label", "reg_weight")


@pytest.fixture(scope="module")
def crop511(tmp_path_factory):
    """Three videos of 12 frames in the crop511 layout: two good tracks
    and a low-quality one (its picks resample among its neighbours)."""
    root = tmp_path_factory.mktemp("crop511_port")
    crop_dir = root / "crop511"
    rng = np.random.default_rng(0)
    ann = {}
    for v, freq, corner in (("video_a", 0.9, 0.05), ("video_b", 0.9, 0.05),
                            ("video_c", 0.3, 0.5)):
        os.makedirs(crop_dir / v)
        track = {}
        for f in range(12):
            im = (rng.random((511, 511, 3)) * 255).astype(np.uint8)
            im[200:310, 190:320] = rng.integers(40, 250, 3)
            cv2.imwrite(str(crop_dir / v / f"{f:06d}.00.x.jpg"), im)
            track[str(f)] = [190.0, 200.0, 320.0, 310.0, 0.9, 0.8,
                             max(0, f - 4), min(11, f + 4), 0.0]
        track["meta"] = {"bbox_picked_freq": freq, "corner_bbox_freq": corner}
        ann[v] = {"00": track}
    ann_path = root / "train.json"
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return crop_dir, ann_path


def _cfg(make, crop511, use=6, mem=2):
    crop_dir, ann_path = crop511
    cfg = make()
    cfg.USOT.TRAIN.WHICH_USE = ["GOT10K"]
    cfg.USOT.DATASET.GOT10K.PATH = str(crop_dir) + "/"
    cfg.USOT.DATASET.GOT10K.ANNOTATION = str(ann_path)
    cfg.USOT.DATASET.GOT10K.USE = use
    cfg.USOT.TRAIN.MEMORY_NUM = mem
    return cfg


def _pair(crop511, seed, cycle_memory, **kw):
    jax_ds = JaxDataset(_cfg(default_config, crop511, **kw), seed=seed)
    port_ds = USOTDataset(_cfg(lambda: load_config(None), crop511, **kw),
                          seed=seed)
    jax_ds.cycle_memory = port_ds.cycle_memory = cycle_memory
    return jax_ds, port_ds


def assert_same_item(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        d = np.abs(ours[k].astype(np.float64) - v)
        if k in EXACT:
            assert np.array_equal(ours[k], v), k
        elif k in IMAGES:
            print(f"{k}: max {d.max()}, {100 * (d > 1).mean():.4f} % over "
                  f"one level, {100 * (d > 0).mean():.4f} % off")
            assert (d > 1).mean() <= 1e-3, k
        else:
            assert d.max() <= 1e-5, k


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cycle_memory", [False, True])
def test_items_equal_jax(crop511, cycle_memory, seed):
    """Both modes, two seeds, four indices each (the low-quality video's
    picks among them)."""
    jax_ds, port_ds = _pair(crop511, seed, cycle_memory)
    assert len(port_ds) == len(jax_ds) == 6
    assert port_ds.pick == jax_ds.pick
    for index in range(4):
        assert_same_item(port_ds[index], jax_ds[index])


def test_pick_lists_and_instances_equal_jax(crop511):
    """The shuffled pick lists of the dataset and of each source, and
    `get_instances` (quality gate, the +-30-video resampling, memory
    frames) from the same generator, draw for draw."""
    for seed in range(4):
        jax_ds, port_ds = _pair(crop511, seed, True, use=17)
        assert port_ds.pick == jax_ds.pick
        assert port_ds.train_datas[0].pick == jax_ds.train_datas[0].pick
    args = ("GOT10K", 0, 2, 0.99, 2)  # video_quality 0.99: all resample
    jax_sub = JaxSubDataset(_cfg(default_config, crop511), *args)
    port_sub = SubDataset(_cfg(lambda: load_config(None), crop511), *args)
    for index in range(3):
        for cyc in (False, True):
            r_jax = np.random.default_rng((3, index))
            r_port = np.random.default_rng((3, index))
            assert port_sub.get_instances(index, cyc, rng=r_port) == \
                jax_sub.get_instances(index, cyc, rng=r_jax)
            assert r_port.bit_generator.state == r_jax.bit_generator.state


def test_loader_batches_do_not_depend_on_workers(crop511):
    """`DataLoader` at 1 and 4 workers: the same batches, the collated
    items in order, drop-last."""
    port_ds = _pair(crop511, 2, False, use=5)[1]
    one = list(DataLoader(port_ds, 2, num_workers=1))
    four = list(DataLoader(port_ds, 2, num_workers=4, prefetch=1))
    assert len(one) == len(four) == 2
    for a, b in zip(one, four):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    ref = collate([port_ds[i] for i in range(2, 4)])
    for k in ref:
        assert np.array_equal(one[1][k], ref[k]), k


def test_loader_raises_an_item_error(crop511):
    """A frame that cannot be read raises with its path, in the consumer
    (JAX's dataset would crash on cv2.imread's None)."""
    port_ds = _pair(crop511, 0, False)[1]
    port_ds.reader = lambda path: None
    with pytest.raises(FileNotFoundError, match="crop511"):
        next(iter(DataLoader(port_ds, 2, num_workers=2)))


def test_frames_from_memory_without_an_image_library(crop511, monkeypatch,
                                                     tmp_path):
    """What the GPU machine runs: cv2 and PIL blocked, frames decoded
    beforehand and passed through the reader as arrays; the items equal
    the ones read from the files. `loader_test` then raises (no writer),
    and with cv2 it writes the debug crops."""
    crop_dir, _ = crop511
    frames = {}
    for dirpath, _, files in os.walk(crop_dir):
        for f in files:
            path = os.path.join(dirpath, f)
            frames[path] = cv2.imread(path)
    ref_ds = _pair(crop511, 4, True)[1]
    refs = [ref_ds[i] for i in range(2)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = USOTDataset(_cfg(lambda: load_config(None), crop511), seed=4,
                     reader=frames.__getitem__)
    ds.cycle_memory = True
    for i, ref in enumerate(refs):
        got = ds[i]
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k
    ds.loader_test = str(tmp_path / "dump")
    with pytest.raises(RuntimeError, match="neither OpenCV"):
        ds[0]
    monkeypatch.undo()
    ds.loader_test = str(tmp_path / "dump")
    ds[0]
    dumped = sorted(os.listdir(tmp_path / "dump"))
    assert len(dumped) == 2 and dumped[0].endswith("_s.jpg")


def test_make_shards_formats_are_shared(crop511, tmp_path):
    """The port's `make_shards` and JAX's write the same format: each
    package's `ShardLoader` reads the other's shard sets, and the two
    sets hold the same samples (as `test_items_equal_jax` holds them)."""
    import yaml

    from usot_tpu.cli.make_shards import main as jax_make_shards
    from usot_tpu.data.shards import ShardLoader as JaxShardLoader
    from usot_tpu_torch.cli.make_shards import main as port_make_shards
    from usot_tpu_torch.data.shards import ShardLoader, epoch_dir

    crop_dir, ann_path = crop511
    cfg = {"USOT": {"TRAIN": {"MEMORY_EPOCH": 2, "MEMORY_NUM": 2,
                              "WHICH_USE": ["GOT10K"]},
                    "DATASET": {"GOT10K": {
                        "PATH": str(crop_dir) + "/",
                        "ANNOTATION": str(ann_path), "USE": 4}}}}
    cfg_path = tmp_path / "shards.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    common = ["--cfg", str(cfg_path), "--epochs", "1-2", "--samples", "3",
              "--shard-size", "2", "--workers", "2"]
    jax_make_shards(common + ["--out", str(tmp_path / "jax")])
    port_make_shards(common + ["--out", str(tmp_path / "port")])
    for epoch, cyc in ((1, False), (2, True)):
        dirs = {side: epoch_dir(str(tmp_path / side), epoch)
                for side in ("jax", "port")}
        metas = {}
        for side, d in dirs.items():
            with open(os.path.join(d, "meta.json")) as f:
                metas[side] = json.load(f)
        assert metas["port"] == metas["jax"]
        assert metas["port"]["cycle_memory"] == cyc
        for side, d in dirs.items():
            ours = list(ShardLoader(d, 3, drop_last=False))
            theirs = list(JaxShardLoader(d, 3, drop_last=False))
            assert len(ours) == len(theirs) == 1
            for k in theirs[0]:
                assert np.array_equal(ours[0][k], theirs[0][k]), (side, k)
        port_batch = next(iter(ShardLoader(dirs["port"], 3)))
        jax_batch = next(iter(ShardLoader(dirs["jax"], 3)))
        for k, v in jax_batch.items():
            d = np.abs(port_batch[k].astype(np.float64) - v)
            limit = 1e-3 if k in IMAGES else 1e-5
            assert (d > 1).mean() <= limit if k in IMAGES \
                else d.max() <= limit, k
