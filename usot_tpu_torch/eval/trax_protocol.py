"""Minimal TraX v3 text-protocol implementation (tracker side).

The port's own copy of `usot_tpu/eval/trax_protocol.py` (ref:
scripts/vot.py:26-121, which relies on the pip `trax` package for the
wire protocol): the same client API surface (`Server`, `Region`,
`Image`, `Rectangle`, `Polygon`, `Mask`), which `cli/vot_wrapper.py`
falls back to when `import trax` fails. Host code, numpy only.

Framing (TraX v3 text): one message per line,

    @@TRAX:<type> "<arg>" "<arg>" ... "key=value" ...

with double-quoted, backslash-escaped arguments. Message flow:

    tracker -> toolkit: hello   (capabilities as properties)
    toolkit -> tracker: initialize "<image>" "<region>"
    tracker -> toolkit: state "<region>" [properties]
    toolkit -> tracker: frame "<image>"
    tracker -> toolkit: state "<region>" [properties]
    ...
    toolkit -> tracker: quit

Region payloads: rectangle "x,y,w,h"; polygon "x1,y1,x2,y2,...";
mask "m<x>,<y>,<w>,<h>,<r1>,<r2>,..." — run lengths over the row-major
(h, w) window starting at offset (x, y), alternating zero/one runs with
the zero run first (the vot-toolkit RLE convention for masks). The run
lengths are computed with numpy (a full-HD mask per frame), to the same
strings as the JAX package's per-pixel loop.
"""
from __future__ import annotations

import re
import sys

import numpy as np

_PROP_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.]*=")


class Region:
    RECTANGLE = "rectangle"
    POLYGON = "polygon"
    MASK = "mask"


class Image:
    PATH = "path"


class Rectangle:
    def __init__(self, x, y, width, height):
        self.x, self.y = float(x), float(y)
        self.width, self.height = float(width), float(height)

    @staticmethod
    def create(x, y, width, height):
        return Rectangle(x, y, width, height)

    def bounds(self):
        return self.x, self.y, self.width, self.height

    def encode(self):
        return f"{self.x},{self.y},{self.width},{self.height}"


class Polygon:
    def __init__(self, points):
        self.points = [(float(x), float(y)) for x, y in points]

    @staticmethod
    def create(points):
        return Polygon(points)

    def __iter__(self):
        return iter(self.points)

    def encode(self):
        return ",".join(f"{x},{y}" for x, y in self.points)


def rle_runs(mask) -> np.ndarray:
    """Alternating run lengths of a mask's row-major pixels, the zero run
    first (0 where the first pixel is set)."""
    flat = np.asarray(mask).reshape(-1) != 0
    if flat.size == 0:
        return np.zeros(1, np.int64)
    edges = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate(([0], edges, [flat.size])))
    return np.concatenate(([0], runs)) if flat[0] else runs


def rle_decode(runs, w: int, h: int) -> np.ndarray:
    """The (h, w) uint8 mask of alternating run lengths (zero run first);
    runs past the window are cut off, a short list leaves zeros."""
    runs = np.maximum(np.asarray(runs, np.int64), 0)
    values = (np.arange(runs.size) % 2).astype(np.uint8)
    pixels = np.repeat(values, runs)[:w * h]
    flat = np.zeros(w * h, np.uint8)
    flat[:pixels.size] = pixels
    return flat.reshape(h, w)


class Mask:
    """Binary mask region with an (x, y) window offset."""

    def __init__(self, mask, offset=(0, 0)):
        self.mask = np.asarray(mask, np.uint8)
        self.offset = (int(offset[0]), int(offset[1]))

    @staticmethod
    def create(mask, offset=(0, 0)):
        return Mask(mask, offset)

    def array(self, full=False, size=None):
        """The mask as ndarray; full=True pads the window out to `size`
        = (width, height) when given (callers without a size get the
        window placed at its offset in a minimally-covering array)."""
        if not full and self.offset == (0, 0):
            return self.mask
        ox, oy = self.offset
        h, w = self.mask.shape
        if size is None:
            fw, fh = ox + w, oy + h
        else:
            fw, fh = size
        out = np.zeros((fh, fw), np.uint8)
        out[oy:min(oy + h, fh), ox:min(ox + w, fw)] = \
            self.mask[:max(min(oy + h, fh) - oy, 0),
                      :max(min(ox + w, fw) - ox, 0)]
        return out

    def encode(self):
        h, w = self.mask.shape
        ox, oy = self.offset
        return "m" + ",".join(
            str(v) for v in [ox, oy, w, h] + rle_runs(self.mask).tolist())


def decode_region(s: str):
    if s.startswith("m"):
        vals = [int(float(v)) for v in s[1:].split(",")]
        ox, oy, w, h = vals[:4]
        return Mask(rle_decode(vals[4:], w, h), (ox, oy))
    vals = [float(v) for v in s.split(",")]
    if len(vals) == 4:
        return Rectangle(*vals)
    return Polygon(list(zip(vals[0::2], vals[1::2])))


def encode_region(region) -> str:
    if isinstance(region, (Rectangle, Polygon, Mask)):
        return region.encode()
    raise TypeError(f"not a region: {region!r}")


# ------------------------------------------------------------------
# Message framing
# ------------------------------------------------------------------

def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def format_message(mtype: str, args=(), properties=None) -> str:
    parts = [f"@@TRAX:{mtype}"]
    parts += [_quote(str(a)) for a in args]
    for k, v in (properties or {}).items():
        parts.append(_quote(f"{k}={v}"))
    return " ".join(parts)


def parse_message(line: str):
    """Returns (type, [args], {properties}) or None for non-TraX lines."""
    line = line.strip()
    if not line.startswith("@@TRAX:"):
        return None
    head, rest = (line.split(" ", 1) + [""])[:2]
    mtype = head[len("@@TRAX:"):]
    args, props = [], {}
    i, n = 0, len(rest)
    while i < n:
        if rest[i] == " ":
            i += 1
            continue
        if rest[i] == '"':
            j, buf = i + 1, []
            while j < n and rest[j] != '"':
                if rest[j] == "\\" and j + 1 < n:
                    buf.append(rest[j + 1])
                    j += 2
                else:
                    buf.append(rest[j])
                    j += 1
            tok = "".join(buf)
            i = j + 1
        else:
            j = rest.find(" ", i)
            j = n if j < 0 else j
            tok = rest[i:j]
            i = j
        # properties are `key=value` with a dotted-identifier key; region
        # payloads (digit-/m-prefixed) and paths (/-prefixed) never match
        if _PROP_RE.match(tok):
            k, v = tok.split("=", 1)
            props[k] = v
        else:
            args.append(tok)
    return mtype, args, props


class _ImageRef:
    def __init__(self, path):
        self._path = path

    def path(self):
        return self._path


class _Request:
    def __init__(self, rtype, region=None, image=None, properties=None):
        self.type = rtype
        self.region = region
        self.image = image or {}
        self.properties = properties or {}


class Server:
    """Tracker-side protocol endpoint (named Server for pip-trax API
    compatibility: the TRACKER serves status reports to the toolkit).
    `fin`/`fout`: the text streams the toolkit speaks on (default
    stdin/stdout)."""

    def __init__(self, regions, images, channels=None, fin=None, fout=None):
        self._fin = fin or sys.stdin
        self._fout = fout or sys.stdout
        self._channels = list(channels or ["color"])
        props = {
            "trax.version": 3,
            "trax.name": "USOT",
            "trax.family": "usot_tpu_torch",
            "trax.region": ";".join(regions),
            "trax.image": ";".join(images),
            "trax.channels": ";".join(self._channels),
        }
        self._send(format_message("hello", (), props))

    def _send(self, line: str):
        self._fout.write(line + "\n")
        self._fout.flush()

    def wait(self) -> _Request:
        while True:
            line = self._fin.readline()
            if not line:
                return _Request("quit")
            msg = parse_message(line)
            if msg is None:
                continue
            mtype, args, props = msg
            if mtype == "initialize":
                image = {c: _ImageRef(a)
                         for c, a in zip(self._channels, args[:-1])}
                return _Request("initialize", decode_region(args[-1]),
                                image, props)
            if mtype == "frame":
                image = {c: _ImageRef(a)
                         for c, a in zip(self._channels, args)}
                return _Request("frame", None, image, props)
            if mtype == "quit":
                return _Request("quit", properties=props)

    def status(self, region, properties=None):
        self._send(format_message(
            "state", (encode_region(region),), properties))

    def quit(self):
        self._send(format_message("quit"))
