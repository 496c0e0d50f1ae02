"""Sphere conv on the card: the structured tables and the wrappers around
the hand-written CUDA kernels.

Kernels (``KERNELS`` maps each wrapper to its TPU kernel and source):
- ``sphere_conv_s1``    B1, forward at stride 1     (csrc/sphere_conv_s1.cu)
- ``sphere_conv_s2``    B2, forward at stride 2     (csrc/sphere_conv_s2.cu)
- ``sphere_conv_dx_s1`` B3, dx at stride 1          (csrc/sphere_conv_dx_s1.cu)
- ``sphere_conv_dx_s1_triple`` B6, dx at stride 1 on the small maps
                                                    (csrc/sphere_conv_dx_triple.cu)
- ``sphere_conv_dx_s2`` B5, dx at stride 2          (csrc/sphere_conv_dx.cu)
- ``sphere_conv_dk``    B4, dK at strides 1 and 2   (csrc/sphere_conv_dk.cu)

Source note. The forward kernels replace
emlight_tpu/nn/sphere_conv_pallas.py::_kernel. They exploit the structure of
the gnomonic sampling pattern, verified here when the tables are built:
- the sampled ROW of every (output row i, tap t, neighbour k) lies within
  [i-2, i+1] (stride 1), so the sources of one output row are a 4-row halo;
- the sampled COLUMN is a constant circular shift s(i, t, k) of the output
  column (times the stride), so no per-pixel index is needed;
- the bilinear weight is one scalar w0(i, t, k) for every column except at
  most one column jdev(i, t, k) where grid_sample's zero pad kills it.
On an H100 every one of them is bound by operations at the model's widths;
each computes its matmul in the kernel itself: B1 (wgmma), B3, B4 and B6
(mma.sync) on the tensor cores, f32 as 3xTF32; the others in f32 on the
CUDA cores. See each .cu file's header for the design; ``s1_plan`` is B1's
tiling and K split, ``dk_plan`` B4's grid and pixel split, ``triple_tiles``
B6's GEMM tiles and K split.

A CPU tensor takes the plain version (nn/sphere_conv.py::sphere_conv_plain,
nn/sphere_conv_vjp.py::dx_plain and dk_plain); a CUDA tensor takes the
kernel or raises. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .kernel_launch import KERNEL_DTYPES, entry, on_cuda, raise_on
from .sphere_conv import sphere_conv_plain, sphere_taps

__all__ = ["structured_tables", "scalar_weight_tables", "sphere_conv_s1", "sphere_conv_s2",
           "sphere_conv_dx", "sphere_conv_dx_s1", "sphere_conv_dx_s1_triple", "sphere_conv_dx_s2",
           "sphere_conv_dk", "triple_tiles", "TriplePlan", "s1_plan", "S1Plan", "dk_plan",
           "DKPlan",
           "tc_width", "KERNELS", "UMAJOR_MIN_PIXELS"]

# wrapper name -> (TPU kernel id, source in the repo, file:line of the TPU kernel)
KERNELS = {
    "sphere_conv_s1": ("B1", "emlight_tpu_torch/csrc/sphere_conv_s1.cu",
                       "emlight_tpu/nn/sphere_conv_pallas.py:113"),  # _kernel, stride 1
    "sphere_conv_s2": ("B2", "emlight_tpu_torch/csrc/sphere_conv_s2.cu",
                       "emlight_tpu/nn/sphere_conv_pallas.py:113"),  # _kernel, stride 2
    "sphere_conv_dx_s1": ("B3", "emlight_tpu_torch/csrc/sphere_conv_dx_s1.cu",
                          "emlight_tpu/nn/sphere_conv_vjp.py:199"),  # _dx_kernel_s1_umajor
    "sphere_conv_dx_s1_triple": ("B6", "emlight_tpu_torch/csrc/sphere_conv_dx_triple.cu",
                                 "emlight_tpu/nn/sphere_conv_vjp.py:159"),  # _dx_kernel_s1
    "sphere_conv_dx_s2": ("B5", "emlight_tpu_torch/csrc/sphere_conv_dx.cu",
                          "emlight_tpu/nn/sphere_conv_vjp.py:293"),  # _dx_kernel_s2
    "sphere_conv_dk": ("B4", "emlight_tpu_torch/csrc/sphere_conv_dk.cu",
                       "emlight_tpu/nn/sphere_conv_vjp.py:455"),  # _dk_kernel
}


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
def _device_tables(h: int, w: int, stride: int, device: str):
    """(rows, shifts, w0, jdev), each (h // stride, 9, 4), copied to `device`
    once per (shape, stride)."""
    rows, shifts, _ = structured_tables(h, w, stride)
    w0, jdev = scalar_weight_tables(h, w, stride)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (rows, shifts, w0, jdev))


@functools.lru_cache(maxsize=None)
def _device_inverse_tables(h: int, w: int, stride: int, device: str):
    """(out_rows, taps, shifts, w0, jdev) of inverse_tables, each (h, fanin),
    on `device`, and fanin."""
    from .sphere_conv_vjp import inverse_tables

    *tabs, fanin = inverse_tables(h, w, stride)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in tabs), fanin


def _packed_table(h: int, w: int, stride: int) -> np.ndarray:
    """(h // stride, 9, 4, 4) int32: per (output row, tap, neighbour) the
    source row, the column shift, the dead column and w0's float bits, which
    a kernel reads as one int4."""
    rows, shifts, _ = structured_tables(h, w, stride)
    w0, jdev = scalar_weight_tables(h, w, stride)
    return np.ascontiguousarray(
        np.stack([rows, shifts, jdev, w0.view(np.int32)], axis=-1).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _device_s1_table(h: int, w: int, device: str) -> tuple[torch.Tensor, int, int]:
    """B1's gather table, ``_packed_table(h, w, 1)``, on `device` once per
    shape; and the least and the largest source row offset (rows - i),
    which size the rows a tile's gather reads."""
    rows, _, _ = structured_tables(h, w, 1)
    offsets = rows - np.arange(h)[:, None, None]
    return (torch.from_numpy(_packed_table(h, w, 1)).to(device),
            min(0, int(offsets.min())), max(0, int(offsets.max())))


@functools.lru_cache(maxsize=None)
def _device_dk_table(h: int, w: int, stride: int, device: str) -> torch.Tensor:
    """B4's gather table, ``_packed_table(h, w, stride)``, on `device` once
    per (shape, stride)."""
    return torch.from_numpy(_packed_table(h, w, stride)).to(device)


@functools.lru_cache(maxsize=None)
def _device_tap_tables(h: int, w: int, device: str):
    """B3's tables from ``tap_grouped_tables(h, w)``: the slots (h, 9, smax,
    4) int32, per slot the output row, the column shift, the dead column and
    w0's float bits (one int4), and the counts (h, 9) int32, on `device`
    once per shape; smax; and the least and the largest output row offset
    of a slot (out_row - r), which size the g rows a tile reads."""
    from .sphere_conv_vjp import tap_grouped_tables

    counts, orow, shifts, w0, jdev, smax = tap_grouped_tables(h, w)
    packed = np.stack([orow, shifts, jdev, w0.view(np.int32)], axis=-1).astype(np.int32)
    live = np.arange(smax)[None, None, :] < counts[..., None]
    offsets = (orow - np.arange(h)[:, None, None])[live]
    return (torch.from_numpy(np.ascontiguousarray(packed)).to(device),
            torch.from_numpy(np.ascontiguousarray(counts)).to(device), smax,
            min(0, int(offsets.min(initial=0))), max(0, int(offsets.max(initial=0))))


class S1Plan(NamedTuple):
    """B1's grid: output tiles of bm flat pixels x bn channels, K walked in
    9 * ceil(cin / bk) steps (step s: channel slab s // 9, tap s % 9; bk is
    16 f32 or 32 bf16 channels, 64 bytes), cut into n_split contiguous
    ranges of `per` steps (the last may be shorter)."""
    bm: int
    bn: int
    bk: int
    tiles_m: int
    tiles_n: int
    n_steps: int
    per: int
    n_split: int


_S1_BM = 128                  # the kernel's BM
_S1_BK = {torch.float32: 16, torch.bfloat16: 32}  # and its BK per dtype
_S1_TARGET_BLOCKS = 264       # 2 blocks per SM of an H100's 132
_S1_SPLIT_MIN_WORK = 1 << 17  # split K only where cin * cout is at least this


def s1_plan(b: int, h: int, w: int, cin: int, cout: int,
            dtype: torch.dtype = torch.float32) -> S1Plan:
    """B1's tiles and K split for x (b, h, w, cin) -> cout in `dtype`:
    128-pixel tiles over the flat b*h*w pixels (so they cross rows and
    images), 128 output channels per tile (64 when cout <= 64); when the
    tiles give fewer than about 2 x 132 blocks and cin * cout >= 2**17 (the
    4x8, 8x16 and 16x32 maps of the generator's wide convs), K is split into
    enough contiguous step ranges to reach that, each summed into its own
    partial."""
    bn = 128 if cout > 64 else 64
    bk = _S1_BK[dtype]
    tiles_m, tiles_n = _cdiv(b * h * w, _S1_BM), _cdiv(cout, bn)
    n_steps = 9 * _cdiv(cin, bk)
    want = 1
    if tiles_m * tiles_n < _S1_TARGET_BLOCKS and cin * cout >= _S1_SPLIT_MIN_WORK:
        want = min(n_steps, _cdiv(_S1_TARGET_BLOCKS, tiles_m * tiles_n))
    per = _cdiv(n_steps, want)
    return S1Plan(_S1_BM, bn, bk, tiles_m, tiles_n, n_steps, per, _cdiv(n_steps, per))


def _check_pair(a: torch.Tensor, b: torch.Tensor, names: str) -> None:
    """Both 4-d, contiguous, of one kernel dtype, on one device."""
    for t in (a, b):
        if t.dim() != 4:
            raise ValueError(f"{names} must be 4-d, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{names} must be float32 or bfloat16, got {a.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"{names} differ in dtype: {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"{names} lie on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{names} must be contiguous")


def _validate(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
              stride: int = 1) -> None:
    _check_pair(x, kernel, "x and kernel")
    cin = x.shape[3]
    if tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    if x.shape[1] % stride or x.shape[2] % stride:
        raise ValueError(f"x {tuple(x.shape)}: H and W must divide by the stride {stride}")
    if bias is not None:
        if tuple(bias.shape) != (kernel.shape[3],) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 ({kernel.shape[3]},)")
        if bias.device != x.device or not bias.is_contiguous():
            raise ValueError("bias must be contiguous on x's device")


def _forward(x, kernel, bias, stride: int, lib_name: str) -> torch.Tensor:
    _validate(x, kernel, bias, stride)
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    rows, shifts, w0, jdev = _device_tables(h, w, stride, str(x.device))
    out = torch.empty(b, h // stride, w // stride, cout, dtype=torch.float32, device=x.device)
    # the launch goes to the current device: make it x's
    with torch.cuda.device(x.device):
        rc = entry(lib_name, lib_name, x.dtype, 8, 5)(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), rows.data_ptr(),
            shifts.data_ptr(), w0.data_ptr(), jdev.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on(rc, lib_name, f"x {tuple(x.shape)} {x.dtype}, cout {cout}")
    return out


def sphere_conv_s1(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 sphere conv: x (B, H, W, Cin) f32/bf16, kernel (3, 3, Cin, Cout)
    HWIO in x's dtype, bias (Cout,) f32 -> (B, H, W, Cout) f32.

    CPU tensor: the plain version. CUDA tensor: on the current stream, the
    kernel's K_t tiling, the kernel with ``s1_plan``'s tiles and, where it
    splits K, the split-order sum of the partials (two or three launches),
    counted once in ``sphere_conv_s1.launches``.
    """
    if not on_cuda(x, "sphere_conv_s1"):
        return sphere_conv_plain(x, kernel, bias, 1)
    _validate(x, kernel, bias, 1)
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    plan = s1_plan(b, h, w, cin, cout, x.dtype)
    table, dmin, dmax = _device_s1_table(h, w, str(x.device))
    # K_t laid out per (n tile, K step) for the kernel's bulk copies; f32
    # holds its TF32 hi and lo parts
    parts = 2 if x.dtype == torch.float32 else 1
    ktiles = torch.empty(plan.tiles_n * plan.n_steps * plan.bn * plan.bk * parts,
                         dtype=x.dtype, device=x.device)
    out = torch.empty(b, h, w, cout, dtype=torch.float32, device=x.device)
    partial = (torch.empty(plan.n_split, b * h * w, cout, dtype=torch.float32, device=x.device)
               if plan.n_split > 1 else out)
    with torch.cuda.device(x.device):
        rc = entry("sphere_conv_s1", "sphere_conv_s1", x.dtype, 7, 11)(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), table.data_ptr(),
            ktiles.data_ptr(), partial.data_ptr(), out.data_ptr(), b, h, w, cin, cout, plan.bn,
            plan.bk, plan.per, plan.n_split, dmin, dmax,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on(rc, "sphere_conv_s1", f"x {tuple(x.shape)} {x.dtype}, cout {cout}")
    sphere_conv_s1.launches += 1
    return out


def sphere_conv_s2(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-2 sphere conv: x (B, H, W, Cin) f32/bf16 with H, W even, kernel
    (3, 3, Cin, Cout) in x's dtype, bias (Cout,) f32 -> (B, H/2, W/2, Cout) f32.

    CPU tensor: the plain version. CUDA tensor: one launch of the CUDA kernel,
    counted in ``sphere_conv_s2.launches``.
    """
    if not on_cuda(x, "sphere_conv_s2"):
        return sphere_conv_plain(x, kernel, bias, 2)
    out = _forward(x, kernel, bias, 2, "sphere_conv_s2")
    sphere_conv_s2.launches += 1
    return out


def _check_dx(g: torch.Tensor, kernel: torch.Tensor, x_shape, stride: int):
    """(b, h, w, cin, cout) of a dx call, after checking its arguments."""
    _check_pair(g, kernel, "g and kernel")
    b, h, w, cin = (int(v) for v in x_shape)
    cout = g.shape[3]
    if h % stride or w % stride or tuple(g.shape) != (b, h // stride, w // stride, cout):
        raise ValueError(f"g {tuple(g.shape)} is not the stride-{stride} output of "
                         f"x {tuple(x_shape)}")
    if tuple(kernel.shape) != (3, 3, cin, cout):
        raise ValueError(f"kernel must be (3, 3, {cin}, {cout}), got {tuple(kernel.shape)}")
    return b, h, w, cin, cout


_TC_WIDTHS = (256, 128, 64, 32)  # the block widths B3 and B4 are built for


def tc_width(n: int) -> int:
    """B3's and B4's block width along N (Cin for B3, Cout for B4): the one
    of 256, 128, 64 and 32 whose tiles pad n least, the widest on a tie."""
    return min(_TC_WIDTHS, key=lambda bn: (_cdiv(n, bn) * bn, -bn))


def sphere_conv_dx_s1(g: torch.Tensor, kernel: torch.Tensor, x_shape) -> torch.Tensor:
    """dx (B, H, W, Cin) f32 of a stride-1 sphere conv from its cotangent g
    (B, H, W, Cout) and kernel (3, 3, Cin, Cout), both in one dtype.

    CPU tensor: ``dx_plain``. CUDA tensor: on the current stream, the K_t
    tiling and the kernel over ``tap_grouped_tables`` (Σ_t Ĝ_t K_tᵀ on the
    tensor cores, no U; the g rows a tile reads staged in shared memory
    where they fit, read from device memory above W = 256), counted once in
    ``sphere_conv_dx_s1.launches``.
    """
    if not on_cuda(g, "sphere_conv_dx_s1"):
        from .sphere_conv_vjp import dx_plain

        return dx_plain(g, kernel, x_shape, 1)
    b, h, w, cin, cout = _check_dx(g, kernel, x_shape, 1)
    slots, counts, smax, dmin, dmax = _device_tap_tables(h, w, str(g.device))
    # K_t as the kernel's B fragments: per K step (64 bytes of Cout channels,
    # one tap) and 8 input channels, 256 words in f32 (TF32 hi and lo), 128
    # in bf16 (its A fragments hold Ĝ's bf16 hi and lo)
    f32 = g.dtype == torch.float32
    n_steps = 9 * _cdiv(cout, 16 if f32 else 32)
    ktiles = torch.empty(n_steps * _cdiv(cin, 8) * (256 if f32 else 128), dtype=torch.int32,
                         device=g.device)
    dx = torch.empty(b, h, w, cin, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = entry("sphere_conv_dx_s1", "sphere_conv_dx_s1", g.dtype, 6, 9)(
            g.data_ptr(), kernel.data_ptr(), ktiles.data_ptr(), slots.data_ptr(),
            counts.data_ptr(), dx.data_ptr(), b, h, w, cin, cout, tc_width(cin), smax, dmin,
            dmax, torch.cuda.current_stream(g.device).cuda_stream,
        )
    raise_on(rc, "sphere_conv_dx_s1", f"g {tuple(g.shape)} {g.dtype}, cin {cin}")
    sphere_conv_dx_s1.launches += 1
    return dx


def sphere_conv_dx_s1_triple(g: torch.Tensor, kernel: torch.Tensor, x_shape) -> torch.Tensor:
    """dx (B, H, W, Cin) f32 of a stride-1 sphere conv, as ``sphere_conv_dx_s1``,
    by the small-map kernel B6: U = g K_tᵀ for every tap as one GEMM on the
    tensor cores (M = pixels, N = 9 * Cin, K = Cout; f32 U, in ``triple_tiles``'
    K splits), then the gather over ``inverse_tables`` in slot order.

    CPU tensor: ``dx_plain``. CUDA tensor: the GEMM and the gather (two
    launches on the current stream), counted once in
    ``sphere_conv_dx_s1_triple.launches``.
    """
    if not on_cuda(g, "sphere_conv_dx_s1_triple"):
        from .sphere_conv_vjp import dx_plain

        return dx_plain(g, kernel, x_shape, 1)
    b, h, w, cin, cout = _check_dx(g, kernel, x_shape, 1)
    (orow, tap, shift, w0, jdev), fanin = _device_inverse_tables(h, w, 1, str(g.device))
    plan = triple_tiles(b, h, w, cin, cout)
    u = torch.empty(plan.n_split, b * h * w, 9 * cin, dtype=torch.float32, device=g.device)
    dx = torch.empty(b, h, w, cin, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = entry("sphere_conv_dx_triple", "sphere_conv_dx_triple", g.dtype, 9, 8)(
            g.data_ptr(), kernel.data_ptr(), orow.data_ptr(), tap.data_ptr(), shift.data_ptr(),
            w0.data_ptr(), jdev.data_ptr(), u.data_ptr(), dx.data_ptr(), b, h, w, cin, cout,
            fanin, plan.per, plan.n_split, torch.cuda.current_stream(g.device).cuda_stream,
        )
    raise_on(rc, "sphere_conv_dx_s1_triple", f"g {tuple(g.shape)} {g.dtype}, cin {cin}")
    sphere_conv_dx_s1_triple.launches += 1
    return dx


def sphere_conv_dx_s2(g: torch.Tensor, kernel: torch.Tensor, x_shape) -> torch.Tensor:
    """dx (B, H, W, Cin) f32 of a stride-2 sphere conv from its cotangent g
    (B, H/2, W/2, Cout) and kernel (3, 3, Cin, Cout), both in one dtype.

    CPU tensor: ``dx_plain``. CUDA tensor: the U product and the gather over
    ``inverse_tables`` (two launches on the current stream), even and odd
    input columns written in place; counted once in
    ``sphere_conv_dx_s2.launches``.
    """
    if not on_cuda(g, "sphere_conv_dx_s2"):
        from .sphere_conv_vjp import dx_plain

        return dx_plain(g, kernel, x_shape, 2)
    b, h, w, cin, cout = _check_dx(g, kernel, x_shape, 2)
    (orow, tap, shift, w0, jdev), fanin = _device_inverse_tables(h, w, 2, str(g.device))
    u = torch.empty(b, 9, h // 2, w // 2, cin, dtype=torch.float32, device=g.device)
    dx = torch.empty(b, h, w, cin, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = entry("sphere_conv_dx", "sphere_conv_dx", g.dtype, 9, 7)(
            g.data_ptr(), kernel.data_ptr(), u.data_ptr(), orow.data_ptr(), tap.data_ptr(),
            shift.data_ptr(), w0.data_ptr(), jdev.data_ptr(), dx.data_ptr(),
            b, h, w, cin, cout, 2, fanin, torch.cuda.current_stream(g.device).cuda_stream,
        )
    raise_on(rc, "sphere_conv_dx_s2", f"g {tuple(g.shape)} {g.dtype}, cin {cin}")
    sphere_conv_dx_s2.launches += 1
    return dx


class TriplePlan(NamedTuple):
    """B6's GEMM grid: tiles_m blocks of bm flat pixels times tiles_n of bn
    rows of N = 9 * Cin (tap-major: kmat's (9, Cin) rows), and K = Cout cut
    into n_split ranges of `per` channels, a whole number of bk-channel
    stages (the last range may be shorter), each summed into its own U
    partial."""
    bm: int
    bn: int
    bk: int
    tiles_m: int
    tiles_n: int
    per: int
    n_split: int


_TRIPLE_BM, _TRIPLE_BN, _TRIPLE_BK = 64, 128, 32  # the GEMM kernel's BM, BN and BK
_TRIPLE_TARGET_BLOCKS = 264  # 2 blocks per SM of an H100's 132


def triple_tiles(b: int, h: int, w: int, cin: int, cout: int) -> TriplePlan:
    """B6's GEMM grid for g (b, h, w, cout) and dx (b, h, w, cin): 64-pixel
    tiles over the flat b*h*w pixels, 128-row tiles over the 9 * cin rows of
    N, and, where those give fewer than about 2 x 132 blocks (the 128 ->
    2048 convs on the 4x8 and 8x16 maps), K cut into enough ranges of whole
    32-channel stages to reach that."""
    tiles_m, tiles_n = _cdiv(b * h * w, _TRIPLE_BM), _cdiv(9 * cin, _TRIPLE_BN)
    stages = _cdiv(cout, _TRIPLE_BK)
    want = 1
    if tiles_m * tiles_n < _TRIPLE_TARGET_BLOCKS:
        want = min(stages, _cdiv(_TRIPLE_TARGET_BLOCKS, tiles_m * tiles_n))
    per = max(1, stages // want) * _TRIPLE_BK
    return TriplePlan(_TRIPLE_BM, _TRIPLE_BN, _TRIPLE_BK, tiles_m, tiles_n, per,
                      _cdiv(cout, per))


# stride-1 dx of a map below this many pixels takes B6, at or above it B3.
# The JAX package's gate is 2048 (emlight_tpu/nn/sphere_conv_vjp.py:290
# _UMAJOR_MIN_PIXELS), set by the TPU's VMEM and loop cost; the port's is
# set by the two kernels' times on the card (chip_smoke.py, "stride-1 dx by
# map"; PERF.md): B6 is the faster from 4x8 to 64x128, by 13 % and more;
# at 128x256 it is ahead by 3 % but forms a U of B*H*W*9*Cin f32 (1.2 GB at
# batch 8 and Cin 128) where B3 forms none, so that map and larger ones
# (256x512 with --crop_size 512) take B3
UMAJOR_MIN_PIXELS = 32768


def sphere_conv_dx(g: torch.Tensor, kernel: torch.Tensor, x_shape, stride: int) -> torch.Tensor:
    """dx by stride and map size: at stride 1 ``sphere_conv_dx_s1_triple``
    (B6) below UMAJOR_MIN_PIXELS pixels, else ``sphere_conv_dx_s1`` (B3); at
    stride 2 ``sphere_conv_dx_s2`` (B5)."""
    if stride == 1:
        if int(x_shape[1]) * int(x_shape[2]) < UMAJOR_MIN_PIXELS:
            return sphere_conv_dx_s1_triple(g, kernel, x_shape)
        return sphere_conv_dx_s1(g, kernel, x_shape)
    if stride == 2:
        return sphere_conv_dx_s2(g, kernel, x_shape)
    raise ValueError(f"sphere conv stride must be 1 or 2, got {stride}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class DKPlan(NamedTuple):
    """B4's grid: tiles_m blocks of bm rows of the flattened (tap, cin) axis
    times tiles_n of bn output channels, and the pixel axis cut into
    n_chunks contiguous chunks of `chunk` pixels (a whole number of
    `slab`-pixel slabs; the last chunk may be shorter)."""
    bm: int
    bn: int
    slab: int
    tiles_m: int
    tiles_n: int
    chunk: int
    n_chunks: int


_DK_BM, _DK_SLAB = 64, 16       # the kernel's BM and KS
_DK_SMS = 132                   # an H100's SMs: one block each
_DK_BLOCK_SLABS = 4             # a block's fixed cost, in slabs' time
_DK_MAX_CHUNKS = 1024
_DK_PARTIAL_BYTES = 64 << 20    # the most the chunks' partials may take


@functools.lru_cache(maxsize=None)
def dk_plan(n_pix: int, cin: int, cout: int) -> DKPlan:
    """B4's grid for n_pix output pixels, x with cin channels, g with cout:
    64-row tiles over the 9 * cin (tap, channel) rows (cin <= 7 puts all 9
    taps in one), ``tc_width(cout)`` channels per tile, and the pixels cut
    into the chunk count that finishes soonest on 132 SMs holding one block
    each: the rounds of blocks, ceil(tiles * chunks / 132), times a block's
    slabs plus its fixed cost, as long as the chunks' partials stay within
    64 MiB."""
    bn = tc_width(cout)
    tiles_m, tiles_n = _cdiv(9 * cin, _DK_BM), _cdiv(cout, bn)
    tiles = tiles_m * tiles_n
    n_slabs = _cdiv(n_pix, _DK_SLAB)
    most = max(1, min(_DK_MAX_CHUNKS, n_slabs, _DK_PARTIAL_BYTES // (9 * cin * cout * 4)))

    def cost(n):
        per = _cdiv(n_slabs, n)
        return _cdiv(tiles * _cdiv(n_slabs, per), _DK_SMS) * (per + _DK_BLOCK_SLABS)

    want = min(range(1, most + 1), key=lambda n: (cost(n), n))
    chunk = _cdiv(n_slabs, want) * _DK_SLAB
    return DKPlan(_DK_BM, bn, _DK_SLAB, tiles_m, tiles_n, chunk, _cdiv(n_pix, chunk))


def sphere_conv_dk(x: torch.Tensor, g: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """dK (3, 3, Cin, Cout) f32 of a stride-1 or stride-2 sphere conv from its
    input x (B, H, W, Cin) and cotangent g (B, H/stride, W/stride, Cout), both
    in one dtype.

    CPU tensor: ``dk_plain``. CUDA tensor: the kernel with ``dk_plan``'s
    grid and, where it cuts the pixels into chunks, the chunk-order sum of
    their partials (one or two launches on the current stream), counted once
    in ``sphere_conv_dk.launches``.
    """
    if not on_cuda(x, "sphere_conv_dk"):
        from .sphere_conv_vjp import dk_plain

        return dk_plain(x, g, stride)
    if stride not in (1, 2):
        raise ValueError(f"sphere conv stride must be 1 or 2, got {stride}")
    _check_pair(x, g, "x and g")
    b, h, w, cin = x.shape
    cout = g.shape[3]
    if h % stride or w % stride or tuple(g.shape[:3]) != (b, h // stride, w // stride):
        raise ValueError(f"g {tuple(g.shape)} is not the stride-{stride} output of "
                         f"x {tuple(x.shape)}")
    table = _device_dk_table(h, w, stride, str(x.device))
    plan = dk_plan(b * (h // stride) * (w // stride), cin, cout)
    dk = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=x.device)
    partial = (torch.empty(plan.n_chunks, 9, cin, cout, dtype=torch.float32, device=x.device)
               if plan.n_chunks > 1 else dk)
    with torch.cuda.device(x.device):
        rc = entry("sphere_conv_dk", "sphere_conv_dk", x.dtype, 5, 9)(
            x.data_ptr(), g.data_ptr(), table.data_ptr(), partial.data_ptr(), dk.data_ptr(),
            b, h, w, cin, cout, stride, plan.bn, plan.chunk, plan.n_chunks,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on(rc, "sphere_conv_dk", f"x {tuple(x.shape)} {x.dtype}, cout {cout}, stride {stride}")
    sphere_conv_dk.launches += 1
    return dk


for _fn in (sphere_conv_s1, sphere_conv_s2, sphere_conv_dx_s1, sphere_conv_dx_s1_triple,
            sphere_conv_dx_s2, sphere_conv_dk):
    _fn.launches = 0
del _fn
