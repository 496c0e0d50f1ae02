"""PIZ compression for the self-contained EXR codec (pure Python/NumPy).

The port's own copy of emlight_tpu/core/piz.py. PIZ is OpenEXR's default
wavelet+Huffman codec and the common wire format for HDR panorama datasets
(Laval Indoor ships PIZ files). This module implements the PIZ chunk format
from the public OpenEXR specification so core/exr.py can ingest (and emit)
PIZ scanline files with no native dependency:

  chunk := minNonZero:u16  maxNonZero:u16
           bitmap[minNonZero..maxNonZero]          (present-value bitset)
           hufLength:u32  hufData[hufLength]       (Huffman stream)

  pipeline (encode): split chunk into per-channel u16 planes -> bitmap the
  occurring u16 values -> forward LUT compacts values to a dense range ->
  per channel (and per u16 lane of FLOAT/UINT channels) a 2-D integer Haar
  wavelet -> one Huffman pass over the whole buffer (with an RLE pseudo
  symbol). Decode is the exact reverse.

Everything except the Huffman bit loops is vectorized; the per-symbol loops
run at about MB/s, so PIZ crops cost host time per image.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode_chunk", "encode_chunk", "PIZ_LINES_PER_CHUNK", "PizError"]

PIZ_LINES_PER_CHUNK = 32
_BITMAP_SIZE = 8192          # 65536 values / 8 bits
_ENC_SIZE = 65537            # u16 range + 1 pseudo (run-length) symbol
_DEC_BITS = 14               # fast-path prefix width of the decoder table
_MAX_CODE_LEN = 58
# code-length table is a stream of 6-bit entries with zero-run escapes
_SHORT_ZEROCODE_RUN = 59     # 59..62 encode runs of 2..5 zero lengths
_LONG_ZEROCODE_RUN = 63      # 63 + 8 bits encodes runs of 6..261
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6


class PizError(ValueError):
    pass


# ---------------------------------------------------------------------------
# bitmap + lookup tables


def _bitmap_from_data(data: np.ndarray):
    """Bitset of occurring u16 values; value 0 is never marked (implicit)."""
    present = np.zeros(65536, dtype=bool)
    present[np.unique(data)] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nz = np.flatnonzero(bitmap)
    if nz.size == 0:
        return bitmap, _BITMAP_SIZE - 1, 0  # all-zero data: empty range
    return bitmap, int(nz[0]), int(nz[-1])


def _forward_lut(bitmap: np.ndarray):
    """value -> dense index (0 maps to 0 even when absent). Returns (lut, max)."""
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(65536, dtype=np.uint16)
    lut[present] = np.arange(np.count_nonzero(present), dtype=np.uint16)
    return lut, int(np.count_nonzero(present)) - 1


def _reverse_lut(bitmap: np.ndarray):
    """dense index -> value. Returns (lut, maxValue)."""
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    vals = np.flatnonzero(present).astype(np.uint16)
    lut = np.zeros(65536, dtype=np.uint16)
    lut[: vals.size] = vals
    return lut, vals.size - 1


# ---------------------------------------------------------------------------
# 2-D integer wavelet (Haar variant; exact integer inverse)
#
# Two arithmetic modes: 14-bit (plain int16 average/difference — values fit,
# no overflow) when maxValue < 2^14, else 16-bit mod-2^16 arithmetic.


def _wenc14(a, b):
    # int32 intermediates: C promotes short+short to int before the shift
    a16 = a.astype(np.int16).astype(np.int32)
    b16 = b.astype(np.int16).astype(np.int32)
    m = (a16 + b16) >> 1
    d = a16 - b16
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    a = ls + (hs & 1) + (hs >> 1)
    b = a - hs
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + 0x8000) & 0xFFFF
    m = (ao + b.astype(np.int32)) >> 1
    d = ao - b.astype(np.int32)
    m = np.where(d < 0, (m + 0x8000) & 0xFFFF, m)
    return m.astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & 0xFFFF
    a = (d + b - 0x8000) & 0xFFFF
    return a.astype(np.uint16), b.astype(np.uint16)


def _wav2_encode(plane: np.ndarray, max_value: int) -> None:
    """In-place 2-D wavelet on a (ny, nx) u16 view; mirrors wav2Encode."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = plane.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            i00, i01 = enc(plane[yy, xx], plane[yy, xx + p])
            i10, i11 = enc(plane[yy + p, xx], plane[yy + p, xx + p])
            plane[yy, xx], plane[yy + p, xx] = enc(i00, i10)
            plane[yy, xx + p], plane[yy + p, xx + p] = enc(i01, i11)
        if nx & p and ys.size:  # odd trailing column (1-D vertical pass)
            x = xs[-1] + p2 if xs.size else 0
            m, d = enc(plane[ys, x], plane[ys + p, x])
            plane[ys, x], plane[ys + p, x] = m, d
        if ny & p and xs.size:  # odd trailing line (1-D horizontal pass)
            y = ys[-1] + p2 if ys.size else 0
            m, d = enc(plane[y, xs], plane[y, xs + p])
            plane[y, xs], plane[y, xs + p] = m, d
        p, p2 = p2, p2 << 1


def _wav2_decode(plane: np.ndarray, max_value: int) -> None:
    """Exact inverse of _wav2_encode (levels in reverse)."""
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    ny, nx = plane.shape
    n = min(nx, ny)
    levels = []
    p, p2 = 1, 2
    while p2 <= n:
        levels.append((p, p2))
        p, p2 = p2, p2 << 1
    for p, p2 in reversed(levels):
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            i00, i10 = dec(plane[yy, xx], plane[yy + p, xx])
            i01, i11 = dec(plane[yy, xx + p], plane[yy + p, xx + p])
            plane[yy, xx], plane[yy, xx + p] = dec(i00, i01)
            plane[yy + p, xx], plane[yy + p, xx + p] = dec(i10, i11)
        if nx & p and ys.size:
            x = xs[-1] + p2 if xs.size else 0
            a, b = dec(plane[ys, x], plane[ys + p, x])
            plane[ys, x], plane[ys + p, x] = a, b
        if ny & p and xs.size:
            y = ys[-1] + p2 if ys.size else 0
            a, b = dec(plane[y, xs], plane[y, xs + p])
            plane[y, xs], plane[y, xs + p] = a, b


# ---------------------------------------------------------------------------
# Huffman coding (canonical codes, 6-bit packed length table, RLE symbol)


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes from lengths the way the PIZ decoder expects:
    codes handed out longest-length-first, then per symbol in index order."""
    counts = np.bincount(lengths, minlength=_MAX_CODE_LEN + 1)
    first = np.zeros(_MAX_CODE_LEN + 1, dtype=np.uint64)
    c = 0
    for l in range(_MAX_CODE_LEN, 0, -1):
        first[l] = c
        c = (c + int(counts[l])) >> 1
    codes = np.zeros(_ENC_SIZE, dtype=np.uint64)
    for l in range(1, _MAX_CODE_LEN + 1):
        idx = np.flatnonzero(lengths == l)
        if idx.size:
            codes[idx] = first[l] + np.arange(idx.size, dtype=np.uint64)
    return codes


class _BitWriter:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def finish(self):
        total = len(self.buf) * 8 + self.nbits
        if self.nbits:
            self.buf.append((self.acc << (8 - self.nbits)) & 0xFF)
        return bytes(self.buf), total


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self, n: int) -> None:
        while self.nbits < n:
            nxt = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | nxt
            self.nbits += 8

    def read(self, n: int) -> int:
        self._fill(n)
        self.nbits -= n
        v = self.acc >> self.nbits
        self.acc &= (1 << self.nbits) - 1
        return v

    def consumed(self) -> int:
        return self.pos * 8 - self.nbits


def _huffman_lengths(freq: np.ndarray) -> np.ndarray:
    """Code lengths from frequencies (standard two-least-merge)."""
    import heapq

    syms = np.flatnonzero(freq)
    lengths = np.zeros(_ENC_SIZE, dtype=np.int64)
    if syms.size == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), [int(s)]) for s in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, ta, la = heapq.heappop(heap)
        fb, tb, lb = heapq.heappop(heap)
        merged = la + lb
        lengths[merged] += 1
        heapq.heappush(heap, (fa + fb, min(ta, tb), merged))
    if lengths.max() > _MAX_CODE_LEN:
        raise PizError("huffman code length exceeds 58 bits")
    return lengths


def _pack_code_lengths(w: _BitWriter, lengths: np.ndarray, im: int, iM: int) -> None:
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            run = 1
            while i + run <= iM and run < 255 + _SHORTEST_LONG_RUN and lengths[i + run] == 0:
                run += 1
            if run >= _SHORTEST_LONG_RUN:
                w.write(_LONG_ZEROCODE_RUN, 6)
                w.write(run - _SHORTEST_LONG_RUN, 8)
                i += run
                continue
            if run > 1:
                w.write(_SHORT_ZEROCODE_RUN + run - 2, 6)
                i += run
                continue
            w.write(0, 6)
        else:
            w.write(l, 6)
        i += 1


def _unpack_code_lengths(r: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(_ENC_SIZE, dtype=np.int64)
    i = im
    while i <= iM:
        l = r.read(6)
        if l == _LONG_ZEROCODE_RUN:
            i += r.read(8) + _SHORTEST_LONG_RUN
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    if i != iM + 1:
        raise PizError("corrupt huffman length table")
    return lengths


def _huf_compress(data: np.ndarray) -> bytes:
    """u16 symbols -> PIZ Huffman block (im, iM, tableLen, nBits header)."""
    freq = np.bincount(data, minlength=_ENC_SIZE).astype(np.int64)
    im = int(np.flatnonzero(freq)[0]) if data.size else 0
    iM = int(np.flatnonzero(freq)[-1]) if data.size else 0
    iM += 1                      # pseudo symbol: the run-length escape code
    freq[iM] = 1
    lengths = _huffman_lengths(freq)
    codes = _canonical_codes(lengths)

    w = _BitWriter()
    _pack_code_lengths(w, lengths, im, iM)
    table_bytes, _ = w.finish()  # byte-padded; data stream starts on a byte

    d = _BitWriter()
    rl_code, rl_len = int(codes[iM]), int(lengths[iM])
    # run-length segmentation (vectorized): starts of equal-value runs,
    # split into (first occurrence + up to 255 repeats) segments
    if data.size:
        arr = data.astype(np.int64)
        starts = np.flatnonzero(np.concatenate(([True], arr[1:] != arr[:-1])))
        run_lens = np.diff(np.concatenate((starts, [arr.size])))
        vals = arr[starts]
        for v, total in zip(vals.tolist(), run_lens.tolist()):
            code, length = int(codes[v]), int(lengths[v])
            while total > 0:
                reps = min(total - 1, 255)  # repeats after the literal
                if length + rl_len + 8 < length * reps:
                    d.write(code, length)
                    d.write(rl_code, rl_len)
                    d.write(reps, 8)
                else:
                    for _ in range(reps + 1):
                        d.write(code, length)
                total -= reps + 1
    data_bytes, n_bits = d.finish()
    header = struct.pack("<IIIII", im, iM, len(table_bytes), n_bits, 0)
    return header + table_bytes + data_bytes


def _huf_decompress(block: bytes, n_out: int) -> np.ndarray:
    if len(block) < 20:
        if n_out == 0:
            return np.zeros(0, dtype=np.uint16)
        raise PizError("truncated huffman block")
    im, iM, _table_len, n_bits, _ = struct.unpack_from("<IIIII", block, 0)
    if not (0 <= im < _ENC_SIZE and 0 <= iM < _ENC_SIZE):
        raise PizError("corrupt huffman header")
    r = _BitReader(memoryview(block)[20:])
    lengths = _unpack_code_lengths(r, im, iM)
    # length table is byte-aligned; data begins at the next byte boundary
    if r.nbits:
        r.acc = 0
        r.nbits = 0
    data_start_bits = r.pos * 8
    codes = _canonical_codes(lengths)

    # fast table over the top _DEC_BITS bits; longer codes go to a dict
    table_len = np.zeros(1 << _DEC_BITS, dtype=np.int32)
    table_lit = np.zeros(1 << _DEC_BITS, dtype=np.int64)
    longs: dict[tuple[int, int], int] = {}
    max_len = 0
    for s in np.flatnonzero(lengths).tolist():
        l = int(lengths[s])
        c = int(codes[s])
        max_len = max(max_len, l)
        if l <= _DEC_BITS:
            base = c << (_DEC_BITS - l)
            table_len[base : base + (1 << (_DEC_BITS - l))] = l
            table_lit[base : base + (1 << (_DEC_BITS - l))] = s
        else:
            longs[(l, c)] = s

    out = np.empty(n_out, dtype=np.uint16)
    i = 0
    rlc = iM
    tl = table_len.tolist()
    ts = table_lit.tolist()
    read = r.read
    while i < n_out:
        r._fill(_DEC_BITS)
        peek = (r.acc >> (r.nbits - _DEC_BITS)) & ((1 << _DEC_BITS) - 1)
        l = tl[peek]
        if l:
            s = ts[peek]
            r.nbits -= l
            r.acc &= (1 << r.nbits) - 1
        else:
            s = None
            for cl in range(_DEC_BITS + 1, max_len + 1):
                r._fill(cl)
                cand = (r.acc >> (r.nbits - cl)) & ((1 << cl) - 1)
                if (cl, cand) in longs:
                    s = longs[(cl, cand)]
                    r.nbits -= cl
                    r.acc &= (1 << r.nbits) - 1
                    break
            if s is None:
                raise PizError("invalid huffman code")
        if s == rlc:
            run = read(8)
            if i == 0 or i + run > n_out:
                raise PizError("corrupt run-length data")
            out[i : i + run] = out[i - 1]
            i += run
        else:
            out[i] = s
            i += 1
        if r.consumed() - data_start_bits > n_bits + 7:
            raise PizError("huffman stream overrun")
    return out


# ---------------------------------------------------------------------------
# chunk encode/decode


def _plane_layout(channel_units: list[int], width: int, n_lines: int):
    """Per-channel (offset, units) into the u16 plane buffer; total count."""
    spans = []
    off = 0
    for units in channel_units:
        n = width * units * n_lines
        spans.append((off, units, n))
        off += n
    return spans, off


def decode_chunk(data: bytes, channel_units: list[int], width: int, n_lines: int) -> bytes:
    """PIZ chunk payload -> raw scanline-interleaved bytes (the NONE layout).

    channel_units: per channel (in file order), pixel size in u16 units
    (HALF=1, FLOAT/UINT=2).
    """
    if len(data) < 4:
        raise PizError("truncated PIZ chunk")
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, dtype=np.uint8)
    if min_nz >= _BITMAP_SIZE or max_nz >= _BITMAP_SIZE:
        raise PizError("corrupt PIZ bitmap range")
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(data, np.uint8, n, pos)
        pos += n
    lut, max_value = _reverse_lut(bitmap)
    (huf_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    spans, total = _plane_layout(channel_units, width, n_lines)
    buf = _huf_decompress(data[pos : pos + huf_len], total)

    for off, units, n in spans:
        plane = buf[off : off + n].reshape(n_lines, width * units)
        for j in range(units):  # each u16 lane wavelets independently
            lane = plane[:, j::units]
            view = np.ascontiguousarray(lane)
            _wav2_decode(view, max_value)
            plane[:, j::units] = view
    buf = lut[buf]

    # reinterleave: line y = channel 0 row y, channel 1 row y, ...
    out = bytearray()
    for y in range(n_lines):
        for off, units, _ in spans:
            row = buf[off + y * width * units : off + (y + 1) * width * units]
            out += row.tobytes()
    return bytes(out)


def encode_chunk(raw: bytes, channel_units: list[int], width: int, n_lines: int) -> bytes:
    """Raw scanline-interleaved bytes -> PIZ chunk payload."""
    spans, total = _plane_layout(channel_units, width, n_lines)
    flat = np.frombuffer(raw, dtype=np.uint16)
    if flat.size != total:
        raise PizError("PIZ chunk size mismatch")
    # de-interleave into per-channel planes
    buf = np.empty(total, dtype=np.uint16)
    pos = 0
    for y in range(n_lines):
        for off, units, _ in spans:
            n = width * units
            buf[off + y * n : off + (y + 1) * n] = flat[pos : pos + n]
            pos += n

    bitmap, min_nz, max_nz = _bitmap_from_data(buf)
    lut, max_value = _forward_lut(bitmap)
    buf = lut[buf]
    for off, units, n in spans:
        plane = buf[off : off + n].reshape(n_lines, width * units)
        for j in range(units):
            view = np.ascontiguousarray(plane[:, j::units])
            _wav2_encode(view, max_value)
            plane[:, j::units] = view
    huf = _huf_compress(buf)

    out = bytearray(struct.pack("<HH", min_nz, max_nz))
    if min_nz <= max_nz:
        out += bitmap[min_nz : max_nz + 1].tobytes()
    out += struct.pack("<I", len(huf))
    out += huf
    return bytes(out)
