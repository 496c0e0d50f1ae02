"""The port's native EXR codec (emlight_tpu_torch.native, built with g++ at
first use) against its pure-Python oracle, core/exr.py, and the JAX
package's codec: bit for bit on every compression (NONE, ZIP, ZIPS, PIZ)
and pixel type (HALF, FLOAT, and UINT, made by retyping a FLOAT file's
channels, which reinterprets its bytes) that tests/test_torch_io.py
covers; the Python codecs read what it writes; read_hdr takes it with no
fallback, and a failed build raises with the compiler's message."""

import concurrent.futures
import struct

import numpy as np
import pytest

from emlight_tpu.core import exr as jexr
from emlight_tpu_torch import native
from emlight_tpu_torch.core import exr as texr
from emlight_tpu_torch.core import hdr as thdr
from test_torch_io import COMPRESSIONS, _hdr_image
from torch_port_helpers import one_torch_thread  # noqa: F401

PIXEL_TYPES = ("half", "float", "uint")


def _retype_as_uint(path):
    """Rewrite a FLOAT file's channel list to UINT: every pixel's 4 bytes
    are then read as a uint32 (converted to float32 by both readers)."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    off = buf.index(b"channels\0chlist\0") + len(b"channels\0chlist\0") + 4
    while buf[off] != 0:
        end = buf.index(b"\0", off)
        (ptype,) = struct.unpack_from("<i", buf, end + 1)
        assert ptype == 2  # FLOAT
        struct.pack_into("<i", buf, end + 1, 0)  # UINT
        off = end + 1 + 16
    with open(path, "wb") as f:
        f.write(buf)


@pytest.mark.parametrize("ptype", PIXEL_TYPES)
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_native_reads_bit_for_bit_as_core_exr(tmp_path, compression, ptype):
    """45 rows end on a partial chunk for ZIP (16 lines) and PIZ (32)."""
    img = _hdr_image(45, 96, seed=1)
    path = str(tmp_path / "a.exr")
    jexr.write_exr(path, img, half=ptype == "half", compression=compression)
    if ptype == "uint":
        _retype_as_uint(path)
    ref = texr.read_exr(path)
    out = native.read_exr(path)
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape == (45, 96, 3)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jexr.read_exr(path))
    if ptype == "uint":
        np.testing.assert_array_equal(out, img.view(np.uint32).astype(np.float32))
    np.testing.assert_array_equal(thdr.read_hdr(path), out)


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
def test_python_reads_what_native_writes(tmp_path, half):
    img = _hdr_image(37, 53, seed=2) * 100
    path = str(tmp_path / "n.exr")
    native.write_exr(path, img, half=half)
    want = img.astype(np.float16).astype(np.float32) if half else img
    for reader in (texr.read_exr, jexr.read_exr, native.read_exr):
        np.testing.assert_array_equal(reader(path), want)


def test_write_hdr_routes_through_native(tmp_path, monkeypatch):
    img = _hdr_image(16, 20, seed=3)
    written = []
    real = native.write_exr
    monkeypatch.setattr(native, "write_exr", lambda *a: written.append(1) or real(*a))
    thdr.write_hdr(str(tmp_path / "rgb.exr"), img)
    assert written == [1]
    np.testing.assert_array_equal(texr.read_exr(str(tmp_path / "rgb.exr")), img)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        thdr.write_hdr(str(tmp_path / "one.exr"), img[..., :1])


def test_read_hdr_has_no_python_fallback(tmp_path, monkeypatch):
    """read_hdr never calls the Python codec, and a file the native decoder
    refuses (no R, G, B planes; RLE compression) raises."""
    img = _hdr_image(16, 20, seed=4)
    monkeypatch.setattr(texr, "read_exr", lambda *a, **k: pytest.fail("Python codec used"))
    ok = str(tmp_path / "ok.exr")
    jexr.write_exr(ok, img, half=True, compression="piz")
    assert thdr.read_hdr(ok).shape == (16, 20, 3)
    ya = str(tmp_path / "ya.exr")
    jexr.write_exr(ya, img[..., :2], channels="YA")
    with pytest.raises(IOError, match="no channel R"):
        thdr.read_hdr(ya)
    rle = str(tmp_path / "rle.exr")
    jexr.write_exr(rle, img, compression="none")
    with open(rle, "rb") as f:
        buf = bytearray(f.read())
    at = buf.index(b"compression\0compression\0") + len(b"compression\0compression\0") + 4
    buf[at] = 1  # RLE
    with open(rle, "wb") as f:
        f.write(buf)
    with pytest.raises(IOError, match="unsupported compression 1"):
        thdr.read_hdr(rle)
    with pytest.raises(IOError, match="cannot open"):
        thdr.read_hdr(str(tmp_path / "missing.exr"))


def _with_comment(path, nbytes):
    """Insert a `nbytes` string attribute at the end of an uncompressed
    file's header, shifting its line offset table by the same amount."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 8
    while buf[off] != 0:  # name, type, size, payload
        for _ in range(2):
            off = buf.index(b"\0", off) + 1
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4 + size
    attr = b"comments\0string\0" + struct.pack("<i", nbytes) + b"x" * nbytes
    table_at = off + 1
    box = buf.index(b"dataWindow\0box2i\0") + len(b"dataWindow\0box2i\0") + 4
    x_min, y_min, x_max, y_max = struct.unpack_from("<4i", buf, box)
    height = y_max - y_min + 1
    offsets = struct.unpack_from(f"<{height + 1}q", buf, table_at)[:height]
    table = struct.pack(f"<{height}q", *(o + len(attr) for o in offsets))
    with open(path, "wb") as f:
        f.write(buf[:off] + attr + buf[off:table_at] + table + buf[table_at + 8 * height:])


def test_a_long_header_and_a_truncated_file(tmp_path):
    """A header longer than a first read (a 20 kB attribute) decodes as
    core/exr.py decodes it; a file cut inside its header or its pixels
    raises."""
    img = _hdr_image(12, 16, seed=5)
    path = str(tmp_path / "long.exr")
    jexr.write_exr(path, img, compression="none")
    _with_comment(path, 20000)
    np.testing.assert_array_equal(native.read_exr(path), texr.read_exr(path))
    np.testing.assert_array_equal(native.read_exr(path), img)
    with open(path, "rb") as f:
        buf = f.read()
    for cut in (5000, len(buf) - 100):
        with open(tmp_path / "cut.exr", "wb") as f:
            f.write(buf[:cut])
        with pytest.raises(IOError, match="truncated"):
            native.read_exr(str(tmp_path / "cut.exr"))


def test_reads_in_threads_agree(tmp_path):
    """The loader thread decodes while another thread works: concurrent
    reads (each releases the GIL in its foreign call) give the same arrays."""
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"c{i}.exr"))
        jexr.write_exr(paths[-1], _hdr_image(40, 64, seed=10 + i), half=True, compression="piz")
    serial = [native.read_exr(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        threaded = list(pool.map(native.read_exr, paths * 2))
    for a, b in zip(serial * 2, threaded):
        np.testing.assert_array_equal(a, b)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    # the source compiled as C: g++ refuses it with its own errors
    monkeypatch.setattr(native, "CXX", ("g++", "-x", "c", "-shared", "-fPIC"))
    with pytest.raises(native.NativeBuildError, match="error") as exc:
        native.read_exr(str(tmp_path / "any.exr"))
    assert "exr_native.cpp" in str(exc.value)
    with pytest.raises(native.NativeBuildError):  # read_hdr: no quiet fallback
        thdr.read_hdr(str(tmp_path / "any.exr"))
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "CXX", ("no-such-compiler",))
    with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
        native.load()
