"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with nvcc for sm_90a into ``build/emlight_tpu_torch/<name>-<digest>.so`` at
the repo root (the digest covers the source and the flags, so an edited
source rebuilds) and loaded with ctypes. The callers declare argtypes and
launch on PyTorch's current stream. A failed build raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "load", "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emlight_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("sphere_conv_s1", "sphere_conv_s2", "sphere_conv_dx_s1", "sphere_conv_dx",
           "sphere_conv_dk", "sphere_conv_dx_triple", "dense_conv")
BUILD_TIMEOUT_S = 600

build_log: dict[str, str] = {}  # nvcc output (ptxas register/smem report) per source
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and str(Path(home) / "bin" / "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> None:
    """Compile every named source that has no library yet: one nvcc per
    source, all started together. Raises if any of them fails."""
    jobs = []
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        build_log[name] = out
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_paths(name)[1]))
            _libs[name] = lib
        return lib
