"""Self-contained OpenEXR scanline codec (no OpenEXR/Imath/cv2 dependency).

The port's own copy of emlight_tpu/core/exr.py (struct, zlib and NumPy; the
port imports nothing of the JAX package), same wire format:

- read:  scanline images, NONE / ZIPS / ZIP / PIZ compression, HALF / FLOAT /
         UINT channels, arbitrary channel names (R,G,B[,A] returned as HxWx3
         float32). PIZ (wavelet+Huffman, the common Laval wire format) decodes
         through core/piz.py.
- write: scanline FLOAT or HALF with ZIP, PIZ, or no compression

The JAX package's optional C++ loader (emlight_tpu/native) is not copied:
this codec is the port's only EXR path.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_exr", "write_exr", "EXRError"]

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP, _PIZ = 0, 1, 2, 3, 4
_LINES_PER_CHUNK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16, _RLE: 1, _PIZ: 32}


class EXRError(ValueError):
    pass


def _read_cstring(buf: bytes, off: int):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes):
    if len(buf) < 8:
        raise EXRError("truncated EXR")
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise EXRError(f"bad EXR magic {magic:#x}")
    if version & 0x200:
        raise EXRError("tiled EXR not supported")
    if version & 0x1000 or version & 0x800:
        raise EXRError("multi-part/deep EXR not supported")
    off = 8
    attrs = {}
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_cstring(buf, off)
        atype, off = _read_cstring(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = (atype, buf[off : off + size])
        off += size
    return attrs, off


def _parse_channels(raw: bytes):
    channels = []
    off = 0
    while raw[off] != 0:
        name, off = _read_cstring(raw, off)
        ptype, _flags, _xs, _ys = struct.unpack_from("<iiii", raw, off)
        off += 16
        channels.append((name, ptype))
    return channels  # already stored in alphabetical order per spec


def _zip_decode(data: bytes, expected: int) -> bytes:
    t = np.frombuffer(zlib.decompress(data), dtype=np.uint8)
    if t.size != expected:
        raise EXRError("zip chunk size mismatch")
    # undo delta predictor: t[i] += t[i-1] - 128 (mod 256)
    d = t.astype(np.int64)
    d[1:] -= 128
    d = np.cumsum(d) % 256
    # undo interleave: first half -> even bytes, second half -> odd bytes
    out = np.empty(expected, dtype=np.uint8)
    half = (expected + 1) // 2
    out[0::2] = d[:half].astype(np.uint8)
    out[1::2] = d[half:].astype(np.uint8)
    return out.tobytes()


def _zip_encode(raw: bytes, level: int = 6) -> bytes:
    a = np.frombuffer(raw, dtype=np.uint8)
    half = (a.size + 1) // 2
    t = np.empty(a.size, dtype=np.uint8)
    t[:half] = a[0::2]
    t[half:] = a[1::2]
    # delta predictor: d[i] = t[i] - t[i-1] + 128 (mod 256)
    d = t.astype(np.int16)
    d[1:] = (d[1:] - t[:-1].astype(np.int16) + 384) % 256
    return zlib.compress(d.astype(np.uint8).tobytes(), level)


def read_exr(path: str, channels: str | None = None) -> np.ndarray:
    """Read a scanline EXR into an (H, W, C) float32 array.

    channels: requested channel letters in output order (default "RGB" when
    present, else all channels alphabetically). Matches the behavior of the
    reference's read_exr (RegressionNetwork/util.py:20-33).
    """
    with open(path, "rb") as f:
        buf = f.read()
    attrs, off = _parse_header(buf)

    chan_list = _parse_channels(attrs["channels"][1])
    comp = struct.unpack("<b", attrs["compression"][1][:1])[0]
    x_min, y_min, x_max, y_max = struct.unpack("<iiii", attrs["dataWindow"][1])
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    if comp not in (_NO_COMPRESSION, _ZIPS, _ZIP, _PIZ):
        raise EXRError(f"unsupported compression {comp}")
    lines_per_chunk = _LINES_PER_CHUNK[comp]
    n_chunks = -(-height // lines_per_chunk)

    # offset table
    offsets = struct.unpack_from(f"<{n_chunks}q", buf, off)

    names = [c[0] for c in chan_list]
    dtypes = {c[0]: _PT_DTYPE[c[1]] for c in chan_list}
    planes = {n: np.empty((height, width), dtype=np.float32) for n in names}
    bytes_per_line = sum(width * np.dtype(dtypes[n]).itemsize for n in names)

    for chunk_off in offsets:
        y, size = struct.unpack_from("<ii", buf, chunk_off)
        data = buf[chunk_off + 8 : chunk_off + 8 + size]
        row0 = y - y_min
        n_lines = min(lines_per_chunk, height - row0)
        expected = bytes_per_line * n_lines
        # a chunk whose compressed size reaches the raw size is stored raw
        if size < expected:
            if comp in (_ZIPS, _ZIP):
                data = _zip_decode(data, expected)
            elif comp == _PIZ:
                from .piz import decode_chunk

                units = [np.dtype(dtypes[n]).itemsize // 2 for n in names]
                data = decode_chunk(data, units, width, n_lines)
        pos = 0
        for li in range(n_lines):
            for n in names:
                dt = np.dtype(dtypes[n])
                nb = width * dt.itemsize
                line = np.frombuffer(data, dtype=dt, count=width, offset=pos)
                planes[n][row0 + li] = line.astype(np.float32)
                pos += nb

    if channels is None:
        channels = "RGB" if all(c in planes for c in "RGB") else "".join(sorted(planes))
    missing = [c for c in channels if c not in planes]
    if missing:
        raise EXRError(f"channels {missing} not in file (has {sorted(planes)})")
    return np.stack([planes[c] for c in channels], axis=-1)


def write_exr(
    path: str,
    data: np.ndarray,
    channels: str = "RGB",
    half: bool = False,
    compression: str = "zip",
) -> None:
    """Write an (H, W, C) array as a scanline EXR.

    Mirrors the reference's write_exr (RegressionNetwork/util.py:301-306) but
    with real compression support and without the OpenEXR dependency.
    """
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        data = data[..., None]
    h, w, c = data.shape
    if c != len(channels):
        raise EXRError(f"data has {c} channels but channel string is {channels!r}")
    comp = {"none": _NO_COMPRESSION, "zip": _ZIP, "zips": _ZIPS,
            "piz": _PIZ}[compression]
    ptype = _PT_HALF if half else _PT_FLOAT
    dtype = _PT_DTYPE[ptype]
    order = sorted(range(c), key=lambda i: channels[i])

    header = bytearray()

    def attr(name: str, atype: str, payload: bytes):
        header.extend(name.encode() + b"\x00" + atype.encode() + b"\x00")
        header.extend(struct.pack("<i", len(payload)))
        header.extend(payload)

    chan_payload = bytearray()
    for i in order:
        chan_payload.extend(channels[i].encode() + b"\x00")
        chan_payload.extend(struct.pack("<iiii", ptype, 0, 1, 1))
    chan_payload.append(0)

    attr("channels", "chlist", bytes(chan_payload))
    attr("compression", "compression", struct.pack("<b", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\x00")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header.append(0)

    lines_per_chunk = _LINES_PER_CHUNK[comp]
    n_chunks = -(-h // lines_per_chunk)
    chunks = []
    for ci in range(n_chunks):
        row0 = ci * lines_per_chunk
        n_lines = min(lines_per_chunk, h - row0)
        parts = []
        for li in range(n_lines):
            for i in order:
                parts.append(data[row0 + li, :, i].astype(dtype).tobytes())
        raw = b"".join(parts)
        if comp in (_ZIP, _ZIPS):
            enc = _zip_encode(raw)
        elif comp == _PIZ:
            from .piz import encode_chunk

            units = [np.dtype(dtype).itemsize // 2] * c
            enc = encode_chunk(raw, units, w, n_lines)
        else:
            enc = raw
        if len(enc) >= len(raw):
            enc = raw  # readers treat size == raw size as uncompressed
        chunks.append((row0, enc))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(bytes(header))
        base = 8 + len(header) + 8 * n_chunks
        off = base
        for _, enc in chunks:
            f.write(struct.pack("<q", off))
            off += 8 + len(enc)
        for row0, enc in chunks:
            f.write(struct.pack("<ii", row0, len(enc)))
            f.write(enc)
