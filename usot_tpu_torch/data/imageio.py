"""Frame decoding for the port's CLI and training dataset: the
counterpart of `cv2.imread` followed by the JAX CLI's gray-to-BGR step
(`usot_tpu/cli/test.py`), and of the dataset's debug `cv2.imwrite`.

The only module of the port that touches an image library. OpenCV is
used where it imports, else Pillow (BGR converted to and from its RGB);
a machine with neither (the GPU machine's installation has neither) can
still track and train on frames held in memory, which pass through
unchanged.
"""
from __future__ import annotations

import numpy as np


def read_image(src):
    """BGR uint8 (H, W, 3) of an image file, as `cv2.imread` gives it;
    None where the file cannot be read or decoded (`cv2.imread`'s
    answer). `src` may also be an (H, W, 3) uint8 array, returned as it
    is, or an (H, W) one, returned as BGR."""
    if isinstance(src, np.ndarray):
        im = src
    else:
        im = _decode(str(src))
        if im is None:
            return None
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=2)
    return im


def _decode(path: str):
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        # IMREAD_COLOR (the default) already gives gray files 3 channels
        return cv2.imread(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode {path}: neither OpenCV (cv2) nor Pillow (PIL) "
            "is installed; install one of them, or pass frames as uint8 "
            "arrays") from None
    try:
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
    except OSError:
        return None
    return np.ascontiguousarray(rgb[..., ::-1])


def write_image(path: str, image: np.ndarray) -> None:
    """Write a BGR uint8 (H, W, 3) array to `path`, its format by the
    extension (`cv2.imwrite`). Raises where neither OpenCV nor Pillow is
    installed, or the file cannot be written."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, image):
            raise OSError(f"cannot write {path}")
        return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot write {path}: neither OpenCV (cv2) nor Pillow (PIL) "
            "is installed") from None
    Image.fromarray(np.ascontiguousarray(image[..., ::-1])).save(path)
