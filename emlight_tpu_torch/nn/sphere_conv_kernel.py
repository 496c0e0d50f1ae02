"""Stride-1 sphere conv on the card: the structured tables and the wrapper
around the hand-written CUDA kernel ``csrc/sphere_conv_s1.cu``.

Source note. The kernel replaces emlight_tpu/nn/sphere_conv_pallas.py::_kernel
at stride 1 (TPU kernel B1). It exploits the structure of the gnomonic
sampling pattern, verified here when the tables are built:
- the sampled ROW of every (output row i, tap t, neighbour k) lies within
  [i-2, i+1], so the sources of one output row are a 4-row halo;
- the sampled COLUMN is a constant circular shift s(i, t, k) of the output
  column, so no per-pixel index is needed;
- the bilinear weight is one scalar w0(i, t, k) for every column except at
  most one column jdev(i, t, k) where grid_sample's zero pad kills it.
On an H100 the conv is bound by operations (f32 on the CUDA cores); the
kernel stages the sampled operand in shared memory and computes the per-tap
matmul there itself. See the .cu file's header for the design.

A CPU tensor takes the plain version (nn/sphere_conv.py::sphere_conv_plain);
a CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .sphere_conv import sphere_conv_plain, sphere_taps

__all__ = ["structured_tables", "scalar_weight_tables", "sphere_conv_s1", "KERNEL_SOURCE",
           "REPLACES"]

KERNEL_SOURCE = "emlight_tpu_torch/csrc/sphere_conv_s1.cu"
REPLACES = "emlight_tpu/nn/sphere_conv_pallas.py:113"  # _kernel, at stride 1


def _check(ok, message: str) -> None:
    if not np.all(ok):
        raise AssertionError(message)


@functools.lru_cache(maxsize=None)
def structured_tables(h: int, w: int, stride: int = 1):
    """Decompose the gather tables into (row, shift, per-column weight).

    Returns:
      rows:   (Ho, 9, 4) int32 — source row, clamped into [0, h)
      shifts: (Ho, 9, 4) int32 — circular column shift (out col j reads input
              col (j*stride + shift) mod w)
      wcol:   (Ho, 9, 4, Wo, 1) float32 — bilinear weight per output column
    """
    idx, wgt, (ho, wo) = sphere_taps(h, w, stride)
    idx = idx.reshape(ho, wo, 9, 4)
    wgt = wgt.reshape(ho, wo, 9, 4)
    rows = idx // w  # already clamped by table construction
    cols = idx % w
    j = (np.arange(wo) * stride)[None, :, None, None]
    shift = (cols - j) % w
    # rows and shifts are column-independent wherever the weight is nonzero;
    # pick the first nonzero-weight column as the canonical value
    mask = wgt > 0
    # column 0 when a whole (i,t,k) row is dead (weight 0)
    first = np.argmax(mask, axis=1)  # (ho, 9, 4)
    gi, gt, gk = np.meshgrid(np.arange(ho), np.arange(9), np.arange(4), indexing="ij")
    rows_c = rows[gi, first, gt, gk].astype(np.int32)
    shift_c = shift[gi, first, gt, gk].astype(np.int32)
    # the structured decomposition must reproduce the exact tables
    recon_cols = (j + shift_c[:, None, :, :]) % w
    _check((recon_cols == cols) | ~mask, "column structure violated")
    _check((rows_c[:, None, :, :] == rows) | ~mask, "row structure violated")
    wcol = np.ascontiguousarray(wgt.transpose(0, 2, 3, 1))[..., None].astype(np.float32)
    return rows_c, shift_c, wcol


@functools.lru_cache(maxsize=None)
def scalar_weight_tables(h: int, w: int, stride: int = 1):
    """Decompose wcol into (scalar, dead-column) form.

    Every (i, t, k) weight row is one constant w0 across all output columns
    except AT MOST one column where grid_sample's zero padding of the
    half-open wrap edge kills it to exactly 0. The kernel rebuilds the
    per-column weight as where(col == jdev, 0, w0), bit-identical to the
    dense table.

    Returns:
      w0:   (Ho, 9, 4) float32 — the constant weight (0 for dead entries)
      jdev: (Ho, 9, 4) int32 — zero-padded output column, or -1 if none
    """
    _, _, wcol = structured_tables(h, w, stride)
    wall = wcol[..., 0]  # (ho, 9, 4, wo)
    w0 = wall.max(axis=3)
    dev = (wall != w0[..., None]) & (w0[..., None] > 0)
    _check(dev.sum(axis=3) <= 1, "more than one deviating column")
    _check(wall[dev] == 0, "deviating weight is not the zero pad")
    jdev = np.where(dev.any(axis=3), dev.argmax(axis=3), -1).astype(np.int32)
    # exact reconstruction (the kernel's arithmetic mirrors this)
    cols = np.arange(wall.shape[3])
    recon = np.where(cols[None, None, None] == jdev[..., None], 0.0, w0[..., None])
    _check(recon == wall, "scalar decomposition is not exact")
    return w0.astype(np.float32), jdev


@functools.lru_cache(maxsize=None)
def _device_tables(h: int, w: int, device: str):
    """(rows, shifts, w0, jdev), each (h, 9, 4), copied to `device` once."""
    rows, shifts, _ = structured_tables(h, w, 1)
    w0, jdev = scalar_weight_tables(h, w, 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (rows, shifts, w0, jdev))


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    from ..kernels import load

    lib = load("sphere_conv_s1")
    fn = getattr(lib, {torch.float32: "sphere_conv_s1_f32",
                       torch.bfloat16: "sphere_conv_s1_bf16"}[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _validate(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    cin = x.shape[3]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    if kernel.dtype != x.dtype:
        raise TypeError(f"kernel dtype {kernel.dtype} differs from x dtype {x.dtype}")
    if kernel.device != x.device:
        raise ValueError(f"kernel on {kernel.device}, x on {x.device}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("x and kernel must be contiguous")
    if bias is not None:
        if tuple(bias.shape) != (kernel.shape[3],) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 ({kernel.shape[3]},)")
        if bias.device != x.device or not bias.is_contiguous():
            raise ValueError("bias must be contiguous on x's device")


def sphere_conv_s1(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 sphere conv: x (B, H, W, Cin) f32/bf16, kernel (3, 3, Cin, Cout)
    HWIO in x's dtype, bias (Cout,) f32 -> (B, H, W, Cout) f32.

    CPU tensor: the plain version. CUDA tensor: one launch of the CUDA kernel
    on the current stream, counted in ``sphere_conv_s1.launches``.
    """
    if x.device.type == "cpu":
        return sphere_conv_plain(x, kernel, bias, 1)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_conv_s1 runs on cpu or cuda, got {x.device}")
    _validate(x, kernel, bias)
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    rows, shifts, w0, jdev = _device_tables(h, w, str(x.device))
    out = torch.empty(b, h, w, cout, dtype=torch.float32, device=x.device)
    # the launch goes to the current device: make it x's
    with torch.cuda.device(x.device):
        rc = _entry(x.dtype)(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), rows.data_ptr(),
            shifts.data_ptr(), w0.data_ptr(), jdev.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sphere_conv_s1 launch failed with CUDA error {rc} "
                           f"at x {tuple(x.shape)} {x.dtype}, cout {cout}")
    sphere_conv_s1.launches += 1
    return out


sphere_conv_s1.launches = 0
