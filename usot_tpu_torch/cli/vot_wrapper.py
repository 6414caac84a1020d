"""VOT2020 / TraX protocol wrapper of the port (ref: scripts/
test_vot2020.py, vot.py).

    python -m usot_tpu_torch.cli.vot_wrapper <ckpt> rectangle|polygon|mask \
        [--mem_size 4] [--width 64] [--channels 256] [--device cpu]

Counterpart of `usot_tpu/cli/vot_wrapper.py`: speaks the TraX text
protocol over stdin/stdout when launched by the vot-toolkit (handshake,
per-frame region reports with the tracker's `cls_score` as the
confidence), through the pip `trax` package where it is installed, else
through the port's own speaker (`eval/trax_protocol.py`). Runs on the GPU
unless `--device cpu` is given; without a GPU and without it, it raises.
Frames are decoded by `data.imageio.read_image` (OpenCV or Pillow)
unless the caller hands `run` a `reader`.
"""
from __future__ import annotations

import argparse
import collections
import sys

import numpy as np

Rectangle = collections.namedtuple("Rectangle", ["x", "y", "width", "height"])
Point = collections.namedtuple("Point", ["x", "y"])
Polygon = collections.namedtuple("Polygon", ["points"])


def make_full_size(x, output_sz):
    """Zero-pad (or crop) a mask to output_sz = [width, height]
    (ref: scripts/test_vot2020.py:21-38)."""
    if x.shape[0] == output_sz[1] and x.shape[1] == output_sz[0]:
        return x
    pad_x = output_sz[0] - x.shape[1]
    if pad_x < 0:
        x = x[:, :x.shape[1] + pad_x]
        pad_x = 0
    pad_y = output_sz[1] - x.shape[0]
    if pad_y < 0:
        x = x[:x.shape[0] + pad_y, :]
        pad_y = 0
    return np.pad(x, ((0, pad_y), (0, pad_x)), "constant",
                  constant_values=0)


def rect_from_mask(mask):
    """Minimal (cx, cy, w, h) rectangle covering a binary mask
    (ref: test_vot2020.py:40-55)."""
    x_ = np.sum(mask, axis=0)
    y_ = np.sum(mask, axis=1)
    x0 = np.min(np.nonzero(x_))
    x1 = np.max(np.nonzero(x_))
    y0 = np.min(np.nonzero(y_))
    y1 = np.max(np.nonzero(y_))
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    return [x0 + w / 2, y0 + h / 2, w, h]


def mask_from_rect(rect, output_sz):
    """Binary mask for a [x0, y0, w, h] rectangle
    (ref: test_vot2020.py:57-69)."""
    mask = np.zeros((output_sz[1], output_sz[0]), dtype=np.uint8)
    x0 = max(int(round(rect[0])), 0)
    y0 = max(int(round(rect[1])), 0)
    x1 = min(int(round(rect[0] + rect[2])), output_sz[0])
    y1 = min(int(round(rect[1] + rect[3])), output_sz[1])
    mask[y0:y1, x0:x1] = 1
    return mask


def _protocol(fin, fout):
    """The pip `trax` package where it is installed and the toolkit's own
    stdio is spoken on, else the port's speaker (which also takes other
    streams)."""
    if fin is None and fout is None:
        try:
            import trax
            return trax
        except ImportError:
            pass
    from usot_tpu_torch.eval import trax_protocol
    return trax_protocol


class VOT:
    """Minimal TraX client (ref: scripts/vot.py:26-121). `fin`/`fout`:
    the streams the toolkit speaks on (default stdin/stdout)."""

    def __init__(self, region_format, channels=None, fin=None, fout=None):
        trax = _protocol(fin, fout)
        assert region_format in (trax.Region.RECTANGLE, trax.Region.POLYGON,
                                 trax.Region.MASK)
        if channels is None:
            channels = ["color"]
        self._trax = trax
        streams = {} if fin is None and fout is None else \
            {"fin": fin, "fout": fout}
        self._handle = trax.Server([region_format], [trax.Image.PATH],
                                   channels, **streams)
        request = self._handle.wait()
        assert request.type == "initialize"
        if isinstance(request.region, trax.Polygon):
            self._region = Polygon([Point(x[0], x[1])
                                    for x in request.region])
        elif isinstance(request.region, trax.Mask):
            # VOT2020 initializes with a segmentation mask
            # (ref: scripts/vot.py:52-53)
            self._region = request.region.array(True)
        else:
            self._region = Rectangle(*request.region.bounds())
        self._image = [x.path() for k, x in request.image.items()]
        if len(self._image) == 1:
            self._image = self._image[0]
        self._handle.status(request.region)

    def region(self):
        return self._region

    def report(self, region, confidence=None):
        """Report a Rectangle, Polygon, or binary-mask ndarray (the
        intended elif chain of ref vot.py:79-86)."""
        trax = self._trax
        assert isinstance(region, (Rectangle, Polygon, np.ndarray))
        if isinstance(region, Polygon):
            tregion = trax.Polygon.create([(x.x, x.y) for x in region.points])
        elif isinstance(region, np.ndarray):
            tregion = trax.Mask.create(region)
        else:
            tregion = trax.Rectangle.create(region.x, region.y, region.width,
                                            region.height)
        properties = {}
        if confidence is not None:
            properties["confidence"] = confidence
        self._handle.status(tregion, properties)

    def frame(self):
        if hasattr(self, "_image"):
            image = self._image
            del self._image
            return image
        request = self._handle.wait()
        if request.type == "frame":
            image = [x.path() for k, x in request.image.items()]
            return image[0] if len(image) == 1 else image
        return None

    def quit(self):
        if hasattr(self, "_handle"):
            self._handle.quit()


def _read(reader, image_file):
    im = reader(image_file)
    if im is None:
        raise RuntimeError(f"cannot read frame {image_file!r}")
    return im


def run(ckpt_path: str = "var/snapshot/USOT_star.pth",
        region_format: str = "rectangle", mem_size: int = 4,
        width: int = 64, channels: int = 256, device=None, reader=None,
        fin=None, fout=None):
    """Track one TraX-served sequence on `device` (default the GPU;
    raises without one unless device="cpu").

    The model comes from `cli.test.load_model`: `ckpt_path` as a torch
    `.pth` or a flax `.ckpt`/`.msgpack`, else (no such file) seeded
    random weights with calibrated BN stats. region_format="mask" is the
    VOT2020 protocol: initialize from the provided segmentation mask's
    bounding rectangle and report each prediction as a full-frame binary
    mask (the rect filled — USOT is a box tracker; ref mask plumbing:
    scripts/vot.py:52-53,84-85 and the mask<->rect helpers in
    scripts/test_vot2020.py:21-69). `reader(path)` gives a frame's BGR
    uint8 array (default `data.imageio.read_image`); `fin`/`fout` are
    the toolkit's streams (default stdin/stdout)."""
    import torch

    from usot_tpu_torch.cli.test import load_model
    from usot_tpu_torch.core.device import f32_numerics, resolve_device
    from usot_tpu_torch.core.geometry import (cxy_wh_2_rect,
                                              get_axis_aligned_bbox)
    from usot_tpu_torch.data.imageio import read_image
    from usot_tpu_torch.tracker.runner import ModelRunner
    from usot_tpu_torch.tracker.tracker import USOTTracker

    device = resolve_device(device)
    f32_numerics()
    reader = reader or read_image
    model = load_model(argparse.Namespace(
        resume=ckpt_path, mem_size=mem_size, width=width,
        channels=channels, dtype="float32"), device)
    runner = ModelRunner(model, device=device)
    tracker = USOTTracker()

    use_mask = region_format == "mask"
    handle = VOT(region_format, fin=fin, fout=fout)
    region = handle.region()
    image_file = handle.frame()
    if not image_file:
        sys.exit(0)

    im = _read(reader, image_file)
    if use_mask:
        mask = make_full_size(np.asarray(region), (im.shape[1], im.shape[0]))
        cx, cy, w, h = rect_from_mask(mask)
    else:
        cx, cy, w, h = get_axis_aligned_bbox(
            np.array([region.x, region.y, region.width, region.height]))
    state = tracker.init(im, np.array([cx, cy]), np.array([w, h]), runner)

    while True:
        image_file = handle.frame()
        if not image_file:
            break
        im = _read(reader, image_file)
        state = tracker.track(state, im)
        rect = cxy_wh_2_rect(state["target_pos"], state["target_sz"])
        conf = state.get("cls_score", 1.0)
        if use_mask:
            handle.report(mask_from_rect(rect, (im.shape[1], im.shape[0])),
                          conf)
        else:
            handle.report(Rectangle(rect[0], rect[1], rect[2], rect[3]),
                          conf)
    handle.quit()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="TraX tracker endpoint")
    ap.add_argument("ckpt", nargs="?", default="var/snapshot/USOT_star.pth")
    ap.add_argument("region_format", nargs="?", default="rectangle")
    ap.add_argument("--mem_size", type=int, default=4)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                    "one). 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    run(a.ckpt, a.region_format, mem_size=a.mem_size, width=a.width,
        channels=a.channels, device=a.device)


if __name__ == "__main__":
    main()
