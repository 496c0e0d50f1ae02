"""The native EXR codec and batch loader (exr_native.cpp), bound through
ctypes.

The port's copy of emlight_tpu/native. At first use
``exr_native.cpp`` is compiled with g++ into
``build/emlight_tpu_torch/exr_native-<digest>.so`` at the repo root (the
digest covers the source and the command, so an edited source rebuilds) and
loaded with ctypes. A ctypes call releases the GIL, so the loader thread of
train/data.py::prefetch decodes while the main thread drives the card.

A failed build raises with the compiler's message, and so does a file the
decoder refuses: nothing falls back to the pure-Python codec (core/exr.py,
about 230 ms for a 192x256 PIZ HALF crop), which stays the oracle the
decoder is tested against and ``read_exr(path, channels=...)``'s reader.

API:
  read_exr(path) -> (H, W, 3) float32, the R, G, B planes
  write_exr(path, arr, half=False): (H, W, 3) float32, ZIP-compressed
  load_batch(paths, out_hw, tonemap=None, n_threads=0)
      -> (N, H, W, 3) float32, alphas (N,) or None: decode + area resize
         (+ TonemapHDR) of a batch in the library's threads
  tonemap_alpha(img, gamma, percentile, max_mapping, apply=False)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["read_exr", "write_exr", "load_batch", "tonemap_alpha", "load", "NativeBuildError"]

SRC = Path(__file__).resolve().parent / "exr_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emlight_tpu_torch"
# no -march=native: a library built on one host may be loaded on another
CXX = ("g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
BUILD_TIMEOUT_S = 300

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_f32p = ctypes.POINTER(ctypes.c_float)


class NativeBuildError(RuntimeError):
    pass


def _lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX).encode()).hexdigest()[:12]
    return BUILD_DIR / f"exr_native-{digest}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*CXX, str(SRC), "-o", str(tmp), "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"building {SRC.name} failed: {' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"building {SRC.name} failed: {' '.join(cmd)}\n"
                               f"{(r.stdout + r.stderr)[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent builds each publish a whole file


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises NativeBuildError
    when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.emlight_last_error.restype = ctypes.c_char_p
            lib.emlight_exr_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_int)]
            lib.emlight_read_exr.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int, ctypes.c_int]
            lib.emlight_write_exr.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int]
            lib.emlight_tonemap_alpha.restype = ctypes.c_float
            lib.emlight_tonemap_alpha.argtypes = [_f32p, ctypes.c_longlong, ctypes.c_float,
                                                  ctypes.c_float, ctypes.c_float, ctypes.c_int]
            lib.emlight_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _f32p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                _f32p, ctypes.c_int]
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, rc: int, ctx: str) -> None:
    if rc != 0:
        raise IOError(f"{ctx}: {lib.emlight_last_error().decode()}")


def read_exr(path: str) -> np.ndarray:
    """Decode a scanline EXR's R, G, B planes as (H, W, 3) float32."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.emlight_exr_dims(os.fsencode(path), ctypes.byref(h), ctypes.byref(w)),
           f"native EXR header {path}")
    out = np.empty((h.value, w.value, 3), np.float32)
    _check(lib, lib.emlight_read_exr(os.fsencode(path), out.ctypes.data_as(_f32p), h.value,
                                     w.value), f"native EXR read {path}")
    return out


def write_exr(path: str, arr: np.ndarray, half: bool = False) -> None:
    """Write (H, W, 3) float32 as a ZIP-compressed FLOAT (or HALF) EXR."""
    lib = load()
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"the native writer takes (H, W, 3) arrays, got {arr.shape}")
    h, w, _ = arr.shape
    _check(lib, lib.emlight_write_exr(os.fsencode(path), arr.ctypes.data_as(_f32p), h, w,
                                      int(half)), f"native EXR write {path}")


def tonemap_alpha(img: np.ndarray, gamma: float = 2.4, percentile: float = 50.0,
                  max_mapping: float = 0.5, apply: bool = False):
    """TonemapHDR's alpha of an image; with ``apply`` also the tonemapped
    (clipped) image, as (image, alpha)."""
    lib = load()
    img = np.array(img, dtype=np.float32, order="C")  # a copy: apply writes in place
    alpha = lib.emlight_tonemap_alpha(img.ctypes.data_as(_f32p), img.size, gamma, percentile,
                                      max_mapping, int(apply))
    return (img, float(alpha)) if apply else float(alpha)


def load_batch(paths: list[str], out_hw: tuple[int, int],
               tonemap: tuple[float, float, float] | None = None, n_threads: int = 0):
    """Decode ``paths``, area-resize each to ``out_hw`` (H, W) and, with
    ``tonemap`` = (gamma, percentile, max_mapping), tonemap it, in the
    library's threads (``n_threads``, 0: one per file up to the host's
    cores) outside the interpreter lock. Returns (imgs (N, H, W, 3) float32,
    alphas (N,) or None); a file the decoder refuses raises IOError naming
    it."""
    lib = load()
    n = len(paths)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.float32)
    alphas = np.empty(n, np.float32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    gamma, pct, mm = tonemap if tonemap else (2.4, 50.0, 0.5)
    rc = lib.emlight_load_batch(c_paths, n, out.ctypes.data_as(_f32p), h, w,
                                int(tonemap is not None), gamma, pct, mm,
                                alphas.ctypes.data_as(_f32p), n_threads)
    _check(lib, rc, "native load_batch")
    return out, (alphas if tonemap is not None else None)
