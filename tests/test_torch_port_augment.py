"""The port's OpenCV counterparts (`usot_tpu_torch.data.cvops`) against
cv2 itself, and its augmentations (`usot_tpu_torch.data.augment`)
against `usot_tpu.data.augment` from the same seeded generator.

Each cvops function gives cv2's answer within one grey level on every
pixel; the share of pixels one level off is printed (`pytest -s`). Each
augmentation leaves its generator in JAX's state: the same draws, in the
same order.
"""
import cv2
import numpy as np
import pytest

import usot_tpu.data.augment as jax_aug
import usot_tpu_torch.data.augment as port_aug
from usot_tpu_torch.data import cvops


def _images(seed):
    """A seeded noise image and a sharp-edged one (flat blocks, a
    diagonal edge), 511x511 BGR uint8, as the crop511 frames are."""
    rng = np.random.default_rng(seed)
    noise = (rng.random((511, 511, 3)) * 255).astype(np.uint8)
    sharp = np.zeros((511, 511, 3), np.uint8)
    sharp[:, :200] = (30, 200, 90)
    sharp[150:380, 120:400] = (250, 20, 140)
    yy, xx = np.mgrid[:511, :511]
    sharp[yy > xx + 100] = (5, 5, 250)
    return noise, sharp


def _diff(ours, ref, tag):
    """Max absolute difference; prints the share of pixels off."""
    d = np.abs(ours.astype(np.int64) - ref.astype(np.int64))
    print(f"{tag}: max {d.max()}, {100 * (d > 0).mean():.4f} % off")
    return int(d.max())


def _crop_mapping(rng, out_sz=255):
    """`USOTDataset._crop_hwc`'s mapping for a jittered crop box, inside
    the 511 frame or reaching out of it."""
    size = rng.uniform(80, 700)
    cx, cy = 255 + rng.uniform(-120, 120, 2)
    x1, y1 = cx - size / 2, cy - size / 2
    a = (out_sz - 1) / size
    return np.array([[a, 0, -a * x1], [0, a, -a * y1]], np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_affine_equals_cv2(seed):
    """The dataset's crop (BORDER_CONSTANT 0, sizes 127 and 255) and a
    rotated mapping, on noise and on sharp edges."""
    rng = np.random.default_rng(100 + seed)
    for k, image in enumerate(_images(seed)):
        for out_sz in (127, 255):
            m = _crop_mapping(rng, out_sz)
            ref = cv2.warpAffine(image, m, (out_sz, out_sz),
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=(0, 0, 0))
            got = cvops.warp_affine(image, m, (out_sz, out_sz))
            assert got.shape == ref.shape and got.dtype == np.uint8
            assert _diff(got, ref, f"crop {k} {out_sz}") <= 1
        rot = cv2.getRotationMatrix2D((250.0, 260.0), rng.uniform(-60, 60),
                                      rng.uniform(0.6, 1.4))
        ref = cv2.warpAffine(image, rot, (300, 280))
        assert _diff(cvops.warp_affine(image, rot, (300, 280)), ref,
                     f"rotation {k}") <= 1


@pytest.mark.parametrize("scale", [0.07, 0.15])
def test_warp_perspective_equals_cv2(scale):
    """`perspective`'s warp (BORDER_REPLICATE) at both jitter scales."""
    rng = np.random.default_rng(int(scale * 100))
    for image in _images(3):
        for size in (127, 255):
            im = np.ascontiguousarray(image[100:100 + size, 90:90 + size])
            src = np.array([[0, 0], [size, 0], [size, size], [0, size]],
                           np.float32)
            dst = (src + rng.normal(0, scale, (4, 2)) * size).astype(
                np.float32)
            h_ref = cv2.getPerspectiveTransform(src, dst)
            h = cvops.perspective_transform(src, dst)
            assert np.allclose(h, h_ref, rtol=1e-6, atol=1e-9)
            ref = cv2.warpPerspective(im, h_ref, (size, size),
                                      borderMode=cv2.BORDER_REPLICATE)
            got = cvops.warp_perspective(im, h, (size, size))
            assert _diff(got, ref, f"perspective {size}") <= 1


def test_resize_nearest_equals_cv2():
    """coarse_dropout's masks: (gh, gw) grids up to the crops' sizes."""
    rng = np.random.default_rng(4)
    for (gh, gw), (w, h) in (((19, 19), (127, 127)), ((38, 38), (255, 255)),
                             ((2, 2), (9, 7)), ((5, 7), (61, 33))):
        m = (rng.random((gh, gw)) < 0.5).astype(np.uint8)
        ref = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(cvops.resize_nearest(m, (w, h)), ref)


def test_bgr_to_hsv_equals_cv2_on_every_colour():
    """All 2^24 BGR colours: equal (cv2's integer tables)."""
    c = np.arange(256)
    grid = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)
    image = grid.reshape(4096, 4096, 3).astype(np.uint8)
    assert np.array_equal(cvops.bgr_to_hsv(image),
                          cv2.cvtColor(image, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 255, 127])
def test_hsv_to_bgr_equals_cv2_on_every_colour(width):
    """All 180 x 256 x 256 HSV triples, in rows of `width` pixels (cv2's
    vectorised loop and its scalar tail round differently)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    flat = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    n = len(flat) // width * width
    image = flat[:n].reshape(-1, width, 3)
    assert _diff(cvops.hsv_to_bgr(image),
                 cv2.cvtColor(image, cv2.COLOR_HSV2BGR),
                 f"hsv2bgr rows of {width}") <= 1


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7, 8, 9])
def test_filter2d_equals_cv2(k):
    """Dense random kernels and `motion_blur`'s rotated line kernels,
    BORDER_REFLECT_101, even and odd sizes."""
    rng = np.random.default_rng(k)
    for image in _images(k):
        im = np.ascontiguousarray(image[:255, 128:383])
        dense = rng.random((k, k)).astype(np.float32)
        dense /= dense.sum()
        assert _diff(cvops.filter2d(im, dense), cv2.filter2D(im, -1, dense),
                     f"filter2d dense {k}") <= 1
        angle = rng.uniform(-60, 60)
        centre = (k / 2 - 0.5, k / 2 - 0.5)
        line = np.zeros((k, k), np.float32)
        line[k // 2, :] = 1.0
        m_ref = cv2.getRotationMatrix2D(centre, angle, 1.0)
        m = cvops.rotation_matrix_2d(centre, angle, 1.0)
        assert np.allclose(m, m_ref, rtol=0, atol=1e-12)
        kernel_ref = cv2.warpAffine(line, m_ref, (k, k))
        kernel = cvops.warp_affine(line, m, (k, k))
        assert kernel.dtype == np.float32
        assert np.abs(kernel - kernel_ref).max() <= 1e-5
        kernel_ref /= kernel_ref.sum()
        assert _diff(cvops.filter2d(im, kernel_ref),
                     cv2.filter2D(im, -1, kernel_ref),
                     f"filter2d motion {k}") <= 1


# ------------------------------------------------------------ augmentations

def _crop(seed, size=255):
    """An augmentation's input: a crop of a frame, as the dataset makes."""
    noise, sharp = _images(seed)
    image = sharp.copy()
    image[::2] = noise[::2]
    off = 60 + 7 * seed
    return np.ascontiguousarray(image[off:off + size, off:off + size])


def _same(fn_jax, fn_port, seed, image, bbox=None):
    """Both sides from `default_rng(seed)`: images within one grey
    level, boxes within 1e-5 px, equal generator states."""
    r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    args = (image,) if bbox is None else (image, bbox)
    out_jax, out_port = fn_jax(*args, r_jax), fn_port(*args, r_port)
    assert r_jax.bit_generator.state == r_port.bit_generator.state
    if bbox is not None:
        (out_jax, box_jax), (out_port, box_port) = out_jax, out_port
        assert np.abs(np.subtract(box_jax, box_port)).max() <= 1e-5
    assert out_port.shape == out_jax.shape and out_port.dtype == np.uint8
    return _diff(out_port, out_jax, getattr(fn_port, "__name__", "aug"))


BOX = [70.3, 81.7, 170.2, 160.9]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", ["multiply_hue_saturation",
                                  "multiply_brightness", "motion_blur",
                                  "coarse_dropout", "salt_and_pepper"])
def test_photometric_augmentation_equals_jax(name, seed):
    image = _crop(seed)
    assert _same(getattr(jax_aug, name), getattr(port_aug, name), seed,
                 image) <= 1


def test_coarse_dropout_and_salt_and_pepper_modes():
    """coarse_dropout's per-channel and shared masks (seeds that draw
    each), and salt_and_pepper without per-channel noise."""
    image = _crop(5, 127)
    modes = set()
    for seed in range(12):
        rng = np.random.default_rng(seed)
        drop_p = rng.uniform(0.0, 0.05)
        modes.add(rng.random() < 0.5 if drop_p > 0 else None)
        assert _same(jax_aug.coarse_dropout, port_aug.coarse_dropout, seed,
                     image) == 0
    assert {True, False} <= modes

    def sp(module):
        return lambda im, rng: module.salt_and_pepper(im, rng,
                                                      per_channel=False)

    assert _same(sp(jax_aug), sp(port_aug), 3, image) == 0


@pytest.mark.parametrize("scale", [(0.01, 0.07), (0.01, 0.15)])
def test_geometric_augmentation_equals_jax(scale):
    for seed in range(3):
        image = _crop(seed, 127 if scale[1] < 0.1 else 255)

        def persp(module):
            return lambda im, box, rng: module.perspective(im, box, rng,
                                                           scale=scale)

        assert _same(persp(jax_aug), persp(port_aug), seed, image, BOX) <= 1
    for flip in ("fliplr", "flipud"):
        out_j = getattr(jax_aug, flip)(image, BOX)
        out_p = getattr(port_aug, flip)(image, BOX)
        assert np.array_equal(out_j[0], out_p[0]) and out_j[1] == out_p[1]


def _stages(cls):
    """`cls`'s steps as (draw of the flip, or None; function name,
    keyword arguments), in the class's order."""
    flips = [(0.4, "fliplr", {}), (0.2, "flipud", {})]
    photo = [(None, n, {}) for n in ("multiply_hue_saturation",
                                     "multiply_brightness", "motion_blur")]
    return {"TemplateAug": flips + [
                (None, "perspective", {"scale": (0.01, 0.07)}),
                (None, "coarse_dropout", {}), (None, "salt_and_pepper", {})],
            "SearchAug": photo,
            "MemoryAug": flips + [
                (None, "perspective", {"scale": (0.01, 0.15)})] + photo}[cls]


GEOMETRIC = ("fliplr", "flipud", "perspective")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cls,size", [("TemplateAug", 127),
                                      ("SearchAug", 255),
                                      ("MemoryAug", 255)])
def test_aug_pipelines_equal_jax(cls, size, seed):
    """The dataset's three pipelines from the same generator.

    Stage by stage, each step of the port's pipeline is held against
    JAX's step on the same input and generator state (one grey level,
    boxes 1e-5 px, equal states after), and the staged run is the
    class's output bitwise. End to end the generator states and boxes
    are equal and the images within one grey level on all but 0.1 % of
    the pixels: cv2's own HSV round trip is not continuous (a pixel one
    level off after the perspective warp may come out of it several
    levels off, as it would in cv2 for that input; measured at most
    0.025 % of the pixels over 12 seeds)."""
    image = _crop(seed, size)
    rng = np.random.default_rng(seed)
    out, box = image, list(BOX)
    for p_flip, name, kw in _stages(cls):
        if p_flip is not None:
            if not rng.random() < p_flip:
                continue
            out_j, box_j = getattr(jax_aug, name)(out, box)
            out, box = getattr(port_aug, name)(out, box)
            assert np.array_equal(out, out_j) and box == box_j
            continue
        r_jax = np.random.default_rng(seed)
        r_jax.bit_generator.state = rng.bit_generator.state
        args = (out, box) if name in GEOMETRIC else (out,)
        res_j = getattr(jax_aug, name)(*args, r_jax, **kw)
        res = getattr(port_aug, name)(*args, rng, **kw)
        assert rng.bit_generator.state == r_jax.bit_generator.state, name
        if name in GEOMETRIC:
            (res_j, box_j), (res, box) = res_j, res
            assert np.abs(np.subtract(box, box_j)).max() <= 1e-5, name
        assert _diff(res, res_j, f"{cls} {name}") <= 1
        out = res

    r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    out_j, box_j = getattr(jax_aug, cls)()(image, BOX, r_jax)
    out_p, box_p = getattr(port_aug, cls)()(image, BOX, r_port)
    assert np.array_equal(out_p, out) and box_p == box
    assert rng.bit_generator.state == r_port.bit_generator.state \
        == r_jax.bit_generator.state
    assert np.abs(np.subtract(box_p, box_j)).max() <= 1e-5
    d = np.abs(out_p.astype(np.int64) - out_j.astype(np.int64))
    print(f"{cls} end to end: max {d.max()}, {100 * (d > 1).mean():.4f} "
          "% over one level")
    assert (d > 1).mean() <= 1e-3
