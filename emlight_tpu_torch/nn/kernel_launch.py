"""What every wrapper of a hand-written kernel shares: the ctypes entry of a
C function of csrc/<name>.cu, the CPU-or-CUDA dispatch test and the launch
error check."""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["KERNEL_DTYPES", "entry", "on_cuda", "raise_on"]

KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def entry(lib_name: str, fn_name: str, dtype: torch.dtype, n_ptr: int, n_int: int):
    """The C function ``<fn_name>_<f32|bf16>`` of csrc/<lib_name>.cu, taking
    n_ptr pointers, n_int ints and the stream, returning a CUDA error code."""
    from ..kernels import load

    fn = getattr(load(lib_name), f"{fn_name}_{KERNEL_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for other devices."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {x.device}")
    return True


def raise_on(rc: int, what: str, detail: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc} at {detail}")
