"""Read and write flax msgpack checkpoints without flax or msgpack.

Counterpart of `utils/checkpoint.py` in the JAX package. The checkpoint
files are flax `serialization.to_bytes` output: a msgpack map of maps whose
leaves are msgpack ext values of type 1, each holding a msgpack ``(shape,
dtype name, raw bytes)`` triple (flax `serialization._ndarray_to_bytes`).
This module decodes and encodes exactly that subset of msgpack in pure
Python, so the port reads the shipped fixtures and writes checkpoints that
the JAX package reads, on a machine that has numpy and nothing of the JAX
stack.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY = 1  # flax serialization._MsgpackExtType.ndarray


class _Reader:
    """Cursor over one msgpack buffer."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        scalar = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalar:
            return self.unpack(scalar[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ndarray_from_bytes(payload)


def _ndarray_from_bytes(payload) -> np.ndarray:
    """Mirror of flax `serialization._ndarray_from_bytes`."""
    inner = _Reader(payload)
    shape, dtype_name, buffer = inner.value()
    if inner.pos != len(inner.buf):
        raise ValueError("trailing bytes in ndarray payload")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def read_msgpack(data: bytes):
    """Decode flax msgpack bytes to nested dicts of numpy arrays, leaf
    dtypes as stored (the counterpart of flax
    `serialization.msgpack_restore`)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def load_params(path: str) -> dict:
    """Load a flax param checkpoint as nested dicts of float32 numpy arrays.

    Float16-stored leaves (the half-size shipped fixtures) are cast up to
    float32, as the JAX package's ``load_params`` casts them to its
    float32 template."""
    with open(path, "rb") as f:
        tree = read_msgpack(f.read())

    def up(node):
        if isinstance(node, dict):
            return {k: up(v) for k, v in node.items()}
        if isinstance(node, np.ndarray) and node.dtype == np.float16:
            return node.astype(np.float32)
        return node

    return up(tree)


