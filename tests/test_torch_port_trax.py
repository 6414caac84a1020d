"""The port's TraX speaker and VOT2020 wrapper against `usot_tpu`'s, on
the CPU.

* region encodings and message framing, both ways: what the port encodes
  JAX decodes to the same region, and the reverse (rectangle, polygon,
  masks with an offset, all-zero and all-one; quotes, escapes, stray
  lines);
* a `rectangle` and a `mask` (VOT2020) session of 8 frames on the trained
  w8c32 fixture (the same `.msgpack` for both packages) over PNG frames,
  the port's `run` against JAX's `run` in this process (both cropping
  with the port's `get_subwindow`), stdin and stdout swapped for text
  streams holding the toolkit's messages: rectangles
  within 0.5 px and confidences within 1e-5 (the parity tolerances,
  PARITY.md:86-87), each mask equal to `mask_from_rect` of its own
  rectangle;
* once through a subprocess with a stub toolkit on its pipes.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import usot_tpu.tracker.tracker as jax_tracker_mod
from usot_tpu.cli import vot_wrapper as jax_wrapper
from usot_tpu.eval import trax_protocol as jtp
from usot_tpu_torch.cli import vot_wrapper as wrapper
from usot_tpu_torch.core.crop import get_subwindow
from usot_tpu_torch.eval import trax_protocol as tp

from test_tracker import synthetic_video
from torch_port_common import FIXTURE, load_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 320
BOX, N_FRAMES = 48, 8


def _masks():
    rng = np.random.default_rng(0)
    return {"random": (rng.random((13, 17)) > 0.6).astype(np.uint8),
            "zeros": np.zeros((4, 5), np.uint8),
            "ones": np.ones((3, 6), np.uint8),
            "first-set": np.eye(5, dtype=np.uint8)}


REGIONS = {
    "rectangle": lambda m: m.Rectangle.create(1.5, 2.0, 30.25, 40.0),
    "polygon": lambda m: m.Polygon.create([(1, 2), (3.5, 4), (5, 6.25)]),
    **{f"mask-{k}": (lambda a: lambda m: m.Mask.create(a, offset=(4, 7)))(a)
       for k, a in _masks().items()},
    "mask-at-origin": lambda m: m.Mask.create(_masks()["random"]),
}


def _same_region(a, b):
    assert type(a).__name__ == type(b).__name__
    if hasattr(a, "bounds"):
        assert a.bounds() == b.bounds()
    elif hasattr(a, "points"):
        assert list(a) == list(b)
    else:
        assert a.offset == b.offset
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.mask.dtype == b.mask.dtype == np.uint8


@pytest.mark.parametrize("case", list(REGIONS) + [
    "framing-state", "framing-escapes", "framing-stray"])
def test_encodings_and_framing_equal_jax(case):
    if case in REGIONS:
        ours, theirs = REGIONS[case](tp), REGIONS[case](jtp)
        assert tp.encode_region(ours) == jtp.encode_region(theirs)
        # the port's string decodes in JAX, JAX's in the port
        _same_region(jtp.decode_region(tp.encode_region(ours)), theirs)
        _same_region(tp.decode_region(jtp.encode_region(theirs)), ours)
        if isinstance(ours, tp.Mask):
            for full, size in ((False, None), (True, None),
                               (True, (30, 25)), (True, (6, 9))):
                np.testing.assert_array_equal(ours.array(full, size),
                                              theirs.array(full, size))
        return
    if case == "framing-state":
        msg = ("state", ("10,20,30,40",), {"confidence": 0.75, "a.b": "x"})
    elif case == "framing-escapes":
        msg = ("frame", ('/tmp/a "b"/c\\d.png', "m0,0,2,1,1,1"),
               {"k": 'say "hi"'})
    else:
        assert tp.parse_message("stray stdout noise") is None
        assert jtp.parse_message("stray stdout noise") is None
        msg = ("quit", (), None)
    line = tp.format_message(*msg)
    assert line == jtp.format_message(*msg)
    assert tp.parse_message(line) == jtp.parse_message(line)
    assert tp.parse_message("  " + line + "\n") == \
        jtp.parse_message("  " + line + "\n")


def test_rle_matches_the_per_pixel_loop_at_720p():
    """The vectorized run lengths equal JAX's loop on a full-frame mask
    (a rectangle filled, the wrapper's report), and decode back."""
    mask = np.zeros((720, 1280), np.uint8)
    mask[100:400, 200:900] = 1
    s = tp.Mask.create(mask).encode()
    assert s == jtp.Mask.create(mask).encode()
    np.testing.assert_array_equal(tp.decode_region(s).mask, mask)


# --------------------------------------------------------------- sessions

def _video(tmp_path):
    """PNG frames of `tests/test_tracker.py`'s synthetic video (a square
    moving 6 px right and 3 px down over noise), its boxes (x, y, w, h)."""
    import cv2

    frames, centers = synthetic_video(n_frames=N_FRAMES, size=H, box=BOX)
    paths, boxes = [], []
    for f, (im, (cx, cy)) in enumerate(zip(frames, centers)):
        p = str(tmp_path / f"{f:04d}.png")
        cv2.imwrite(p, im)
        paths.append(p)
        boxes.append((cx - BOX // 2, cy - BOX // 2, BOX, BOX))
    return paths, boxes


def _toolkit_messages(m, paths, boxes, region_format):
    x, y, w, h = boxes[0]
    if region_format == "mask":
        init = np.zeros((H, W), np.uint8)
        init[y:y + h, x:x + w] = 1
        region = m.Mask.create(init)
    else:
        region = m.Rectangle.create(x, y, w, h)
    lines = [m.format_message("initialize", (paths[0],
                                             m.encode_region(region)))]
    lines += [m.format_message("frame", (p,)) for p in paths[1:]]
    lines.append(m.format_message("quit"))
    return "\n".join(lines) + "\n"


def _session(monkeypatch, run, m, paths, boxes, region_format, **kw):
    """One session through sys.stdin/sys.stdout; returns the parsed
    `state` messages after the init's echo."""
    out = io.StringIO()
    with monkeypatch.context() as mp:
        mp.setattr(sys, "stdin", io.StringIO(
            _toolkit_messages(m, paths, boxes, region_format)))
        mp.setattr(sys, "stdout", out)
        run(FIXTURE, region_format, **kw)
    msgs = [m.parse_message(ln) for ln in out.getvalue().splitlines()]
    msgs = [x for x in msgs if x is not None]
    assert msgs[0][0] == "hello" and msgs[-1][0] == "quit"
    assert "trax.region" in msgs[0][2]
    states = [x for x in msgs if x[0] == "state"]
    assert len(states) == N_FRAMES  # the init's echo, then every frame
    return states[1:]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both wrappers crop with the port's `get_subwindow`: its one
    intended difference from JAX's (cv2's fixed point against float
    bilinear, at most a grey level) is `test_torch_port_tracker.py`'s,
    and on free-running trajectories it would decide the gap."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tracker_mod, "get_subwindow", get_subwindow)
    kw, _ = load_fixture()
    paths, boxes = _video(tmp_path_factory.mktemp("trax"))
    out = {}
    for fmt in ("rectangle", "mask"):
        out["port", fmt] = _session(mp, wrapper.run, tp, paths, boxes, fmt,
                                    device="cpu", **kw)
        out["jax", fmt] = _session(mp, jax_wrapper.run, jtp, paths, boxes,
                                   fmt, **kw)
    mp.undo()
    return out


def _rects(states, m):
    return np.array([m.decode_region(s[1][0]).bounds() for s in states])


def _confidences(states):
    return np.array([float(s[2]["confidence"]) for s in states])


def test_rectangle_session_matches_jax(sessions):
    ours, theirs = sessions["port", "rectangle"], \
        sessions["jax", "rectangle"]
    err = np.abs(_rects(ours, tp) - _rects(theirs, jtp)).max()
    assert err <= 0.5, err
    np.testing.assert_allclose(_confidences(ours), _confidences(theirs),
                               rtol=0, atol=1e-5)
    # the tracker follows the square (trained weights)
    assert np.all(_rects(ours, tp)[:, 2:] > 0)


def test_mask_session_matches_jax(sessions):
    """Each reported mask is the full frame's `mask_from_rect` of its own
    package's rectangle session (the init mask's box is the rectangle
    session's init box), nonempty; the confidences are JAX's."""
    for pkg, m in (("port", tp), ("jax", jtp)):
        rects = _rects(sessions[pkg, "rectangle"], m)
        for s, rect in zip(sessions[pkg, "mask"], rects):
            mask = m.decode_region(s[1][0]).array(True, (W, H))
            assert mask.shape == (H, W) and mask.sum() > 0
            np.testing.assert_array_equal(
                mask, wrapper.mask_from_rect(rect, (W, H)))
    np.testing.assert_allclose(_confidences(sessions["port", "mask"]),
                               _confidences(sessions["jax", "mask"]),
                               rtol=0, atol=1e-5)


def test_mask_helpers_equal_jax():
    rng = np.random.default_rng(2)
    m = np.zeros((30, 40), np.uint8)
    m[5:17, 9:31] = rng.random((12, 22)) > 0.3
    assert wrapper.rect_from_mask(m) == jax_wrapper.rect_from_mask(m)
    for size in ((40, 30), (50, 35), (20, 12), (45, 20)):
        np.testing.assert_array_equal(wrapper.make_full_size(m, size),
                                      jax_wrapper.make_full_size(m, size))
    for rect in ((3.4, 2.6, 10.2, 7.7), (-5, -3, 20, 20), (35, 25, 30, 30)):
        np.testing.assert_array_equal(
            wrapper.mask_from_rect(rect, (40, 30)),
            jax_wrapper.mask_from_rect(rect, (40, 30)))


def test_wrapper_subprocess_mask_protocol(tmp_path):
    """`python -m usot_tpu_torch.cli.vot_wrapper <fixture> mask --device
    cpu` with a stub toolkit on its pipes: hello, the init's echo, a
    full-frame mask with a confidence per frame, quit."""
    kw, _ = load_fixture()
    paths, boxes = _video(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "usot_tpu_torch.cli.vot_wrapper", FIXTURE,
         "mask", "--device", "cpu", "--width", str(kw["width"]),
         "--channels", str(kw["channels"]), "--mem_size",
         str(kw["mem_size"])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)

    def expect(mtype):
        while True:
            line = proc.stdout.readline()
            assert line, (mtype, proc.stderr.read())
            msg = tp.parse_message(line)
            if msg is not None:
                assert msg[0] == mtype, msg
                return msg

    def send(mtype, args=()):
        proc.stdin.write(tp.format_message(mtype, args) + "\n")
        proc.stdin.flush()

    try:
        _, _, hello = expect("hello")
        assert hello["trax.region"] == "mask"
        assert hello["trax.image"] == "path"
        x, y, w, h = boxes[0]
        init = np.zeros((H, W), np.uint8)
        init[y:y + h, x:x + w] = 1
        send("initialize", (paths[0], tp.Mask.create(init).encode()))
        _, args, _ = expect("state")
        np.testing.assert_array_equal(
            tp.decode_region(args[0]).array(True, (W, H)), init)
        for p in paths[1:]:
            send("frame", (p,))
            _, args, props = expect("state")
            mask = tp.decode_region(args[0]).array(True, (W, H))
            assert mask.shape == (H, W) and mask.sum() > 0
            assert 0.0 <= float(props["confidence"]) <= 1.0
        send("quit")
        expect("quit")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
