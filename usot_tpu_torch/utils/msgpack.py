"""A reader of flax's msgpack checkpoints in plain Python and numpy.

Counterpart of `flax.serialization.msgpack_restore` for the files that
`usot_tpu` writes (`train/checkpoint.py`: `checkpoint_eN.ckpt`; the
committed `tests/fixtures/*.msgpack`), without the `flax` or `msgpack`
packages, which the GPU machine does not have. It decodes the subset of
msgpack that `flax.serialization.to_bytes` writes:

* maps, arrays, str, bin, ints, floats, bool and nil;
* ext type 1, an ndarray, whose payload is itself msgpack of
  `(shape, dtype name, C-order bytes)` (flax's `_ndarray_to_bytes`), and
  ext type 3, a numpy scalar in the same encoding. A `bfloat16` array
  comes back as a torch tensor (numpy has no such type); every other
  array as a read-only numpy view of the file's bytes, as flax returns
  it;
* flax's chunked form of an array over 2**30 bytes
  (`{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`),
  joined back into one array.

Arrays decode as msgpack lists, as `msgpack_restore` gives them. Any
other ext type raises, naming it.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decodes one msgpack object at a time from `data` (bytes)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (the ndarray payload's dtype name)

    def _take(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code == _NDARRAY:
            return _ndarray(payload)
        if code == _NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
        name = "native complex" if code == _COMPLEX else "unknown"
        raise ValueError(f"msgpack: ext type {code} ({name}) is not part of "
                         "what usot_tpu's checkpoints hold")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._unpack({0xC7: ">B", 0xC8: ">H",
                                           0xC9: ">I"}[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H",
                                           0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):  # array 16/32
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(payload):
    """flax's `_ndarray_from_bytes`: msgpack (shape, dtype name, bytes)."""
    shape, name, buf = _Reader(payload, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) \
            if len(buf) else torch.empty(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(node):
    """flax's `_unchunk`: the chunks of a flattened array, in key order
    "0", "1", ..., joined and reshaped."""
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def msgpack_restore(data: bytes):
    """The tree `flax.serialization.msgpack_restore(data)` returns: dicts
    with str keys, lists, Python scalars, numpy arrays (torch tensors for
    bfloat16)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the top-level object")
    return _unchunk_tree(tree)


def read_msgpack(path: str):
    """`msgpack_restore` of the file at `path`."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
