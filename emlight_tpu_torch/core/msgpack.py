"""A stdlib msgpack codec for flax's checkpoint wire format.

The JAX package checkpoints its train states with
``flax.serialization.to_bytes`` (emlight_tpu/train/checkpoint.py): the state
dict as msgpack, tuples and lists as maps keyed "0", "1", ..., every array
(the 0-d ``step`` too) as ext type 1 whose payload is msgpack of
``(shape, dtype name, bytes in C order)``; ext type 3 is a NumPy scalar
(the same payload, unpacked to a scalar), ext type 2 a Python complex
(msgpack of ``(real, imag)``). Arrays above 2**30 bytes are stored as a map
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` of
flat pieces. The port reads and writes that format with the standard library
and NumPy alone:

- ``unpackb``: msgpack -> Python values, with flax's ext types decoded
  (as ``msgpack.unpackb(data, ext_hook=flax's hook, raw=False)``);
- ``msgpack_restore``: ``unpackb``, then chunked arrays joined
  (``flax.serialization.msgpack_restore``);
- ``packb``: the writer for the port's own checkpoints, trees of dicts
  and NumPy arrays only (``msgpack.packb(tree, default=flax's hook)``);
  dicts keep their key order, as ``to_bytes`` does. It does not write the
  chunked form, and raises on an array above 2**30 bytes.

Arrays are read with ``np.frombuffer`` over the input buffer, without
copying, so they are read-only views that keep the buffer alive. A
``bfloat16`` array (NumPy has no such type) is read as raw 16-bit words and
widened exactly to float32 through ``torch.bfloat16``.
"""

from __future__ import annotations

import struct
from collections import namedtuple

import numpy as np

__all__ = ["unpackb", "packb", "msgpack_restore", "ExtType", "MsgpackError", "MAX_CHUNK_SIZE"]

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"

ExtType = namedtuple("ExtType", "code data")  # an ext type flax does not define


class MsgpackError(ValueError):
    pass


class _Decoder:
    """Recursive descent over one buffer. ``views`` (an array payload): bin
    and str values come back as memoryview slices of the buffer, raw, as
    flax reads the payload (``raw=True``: a writer without the bin type
    stores the bytes as str); else bin as bytes and str decoded."""

    def __init__(self, buf, views: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def str_(self, n: int):
        s = self.take(n)
        return s if self.views else str(s, "utf-8")

    def bin_(self, n: int):
        b = self.take(n)
        return b if self.views else bytes(b)

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_value(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.decode() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.decode()
            out[key] = self.decode()
        return out

    def decode(self):
        if self.pos >= len(self.buf):
            raise MsgpackError(f"truncated msgpack at offset {self.pos}")
        b = self.buf[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map_(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str_(b & 0x1F)
        handler = _DISPATCH.get(b)
        if handler is None:
            raise MsgpackError(f"invalid msgpack type byte {b:#04x} at offset {self.pos - 1}")
        return handler(self)


_DISPATCH = {
    0xC0: lambda d: None,
    0xC2: lambda d: False,
    0xC3: lambda d: True,
    0xC4: lambda d: d.bin_(d.unpack(">B")),
    0xC5: lambda d: d.bin_(d.unpack(">H")),
    0xC6: lambda d: d.bin_(d.unpack(">I")),
    0xC7: lambda d: d.ext(d.unpack(">B")),
    0xC8: lambda d: d.ext(d.unpack(">H")),
    0xC9: lambda d: d.ext(d.unpack(">I")),
    0xCA: lambda d: d.unpack(">f"),
    0xCB: lambda d: d.unpack(">d"),
    0xCC: lambda d: d.unpack(">B"),
    0xCD: lambda d: d.unpack(">H"),
    0xCE: lambda d: d.unpack(">I"),
    0xCF: lambda d: d.unpack(">Q"),
    0xD0: lambda d: d.unpack(">b"),
    0xD1: lambda d: d.unpack(">h"),
    0xD2: lambda d: d.unpack(">i"),
    0xD3: lambda d: d.unpack(">q"),
    0xD4: lambda d: d.ext(1),
    0xD5: lambda d: d.ext(2),
    0xD6: lambda d: d.ext(4),
    0xD7: lambda d: d.ext(8),
    0xD8: lambda d: d.ext(16),
    0xD9: lambda d: d.str_(d.unpack(">B")),
    0xDA: lambda d: d.str_(d.unpack(">H")),
    0xDB: lambda d: d.str_(d.unpack(">I")),
    0xDC: lambda d: d.array(d.unpack(">H")),
    0xDD: lambda d: d.array(d.unpack(">I")),
    0xDE: lambda d: d.map_(d.unpack(">H")),
    0xDF: lambda d: d.map_(d.unpack(">I")),
}


def _ndarray_from_payload(payload: memoryview) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: payload = msgpack (shape, dtype name,
    bytes); the array is a view of the payload's bytes."""
    shape, name, buf = _Decoder(payload, views=True).decode()
    name = bytes(name).decode("ascii")
    if name == "bfloat16":
        import torch

        words = np.frombuffer(buf, np.int16).copy()
        arr = torch.from_numpy(words).view(torch.bfloat16).float().numpy()
    else:
        arr = np.frombuffer(buf, np.dtype(name))
    return arr.reshape(shape)


def _ext_value(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(payload)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(payload)[()]
    if code == EXT_COMPLEX:
        real, imag = _Decoder(payload).decode()
        return complex(real, imag)
    return ExtType(code, bytes(payload))


def unpackb(data):
    """Decode one msgpack object from ``data`` (bytes, bytearray or a
    memoryview); flax's ext types come back as NumPy arrays, NumPy scalars
    and complex numbers. Trailing bytes raise."""
    dec = _Decoder(data)
    out = dec.decode()
    if dec.pos != len(dec.buf):
        raise MsgpackError(f"{len(dec.buf) - dec.pos} trailing bytes after the msgpack object")
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data):
    """``unpackb``, then flax's chunked arrays joined back into arrays."""
    return _unchunk(unpackb(data))


# -- encoder -------------------------------------------------------------------


def _pack_len(out: list, n: int, fix: int | None, fix_max: int, codes) -> None:
    if fix is not None and n <= fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_uint(out: list, v: int) -> None:
    if v < 0x80:
        out.append(bytes((v,)))
    elif v < 1 << 8:
        out.append(struct.pack(">BB", 0xCC, v))
    elif v < 1 << 16:
        out.append(struct.pack(">BH", 0xCD, v))
    elif v < 1 << 32:
        out.append(struct.pack(">BI", 0xCE, v))
    else:
        out.append(struct.pack(">BQ", 0xCF, v))


def _pack_str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out.append(b)


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ndarray(out: list, arr: np.ndarray, path: str) -> None:
    """Ext type 1 around flax's ``_ndarray_to_bytes`` payload; the array's
    bytes are passed as a view, not copied."""
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise MsgpackError(f"{path}: object and structured dtypes are not serializable")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise MsgpackError(f"{path}: {arr.nbytes} bytes is above 2**30, which flax writes "
                           "as a __msgpack_chunked_array__; this writer does not")
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make 0-d arrays 1-d)
        arr = arr.copy(order="C")
    parts: list = [b"\x93"]  # a 3-array: shape, dtype name, bytes
    _pack_len(parts, arr.ndim, 0x90, 15, (None, 0xDC, 0xDD))
    for d in arr.shape:
        _pack_uint(parts, d)
    _pack_str(parts, arr.dtype.name)
    data = memoryview(arr).cast("B") if arr.nbytes else b""
    _pack_len(parts, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    n = sum(len(p) for p in parts) + len(data)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], EXT_NDARRAY))
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", EXT_NDARRAY))
    out.extend(parts)
    out.append(data)


def _pack(out: list, obj, path: str) -> None:
    if isinstance(obj, np.ndarray):
        _pack_ndarray(out, obj, path)
    elif type(obj) is dict:
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if type(k) is not str:
                raise MsgpackError(f"{path}: key {k!r} is not a str")
            _pack_str(out, k)
            _pack(out, v, f"{path}/{k}")
    else:
        raise MsgpackError(f"{path}: cannot serialize {type(obj).__name__} (a checkpoint "
                           "tree is dicts of NumPy arrays)")


def packb(tree: dict) -> bytes:
    """Encode a tree of dicts (str keys, in their order) and NumPy arrays as
    ``flax.serialization.to_bytes`` writes a state dict; anything else, and
    an array above 2**30 bytes, raises."""
    out: list = []
    _pack(out, tree, "$")
    return b"".join(out)
