"""The dense layer's fused affine 3x3 conv on the card: wrappers around the
hand-written CUDA kernels of csrc/dense_conv.cu.

- ``dense_conv_fwd`` B7,  conv3x3(x * a + b, K)
- ``dense_conv_dx``  B7', dx = conv_T(g, K) * a and da, db
- ``dense_conv_dk``  B8,  dK

All three run on the tensor cores (mma.sync, f32 as 3xTF32); B7 and B7'
on ``dx_blocks``' persistent grid.

``KERNELS`` maps each wrapper to its TPU kernel and source. A CPU tensor
takes the plain version (nn/dense_conv.py); a CUDA tensor takes the kernel or
raises. Each wrapper counts its launches in ``.launches``. Inputs are
float32 or bfloat16, contiguous; a and b float32; outputs float32. See the
.cu file's header for the design.
"""

from __future__ import annotations

import torch

from .kernel_launch import KERNEL_DTYPES, entry, on_cuda, raise_on

__all__ = ["dense_conv_fwd", "dense_conv_dx", "dense_conv_dk", "dx_blocks", "dk_chunks",
           "KERNELS"]

_SRC = "emlight_tpu_torch/csrc/dense_conv.cu"
# wrapper name -> (TPU kernel id, source in the repo, file:line of the TPU kernel)
KERNELS = {
    "dense_conv_fwd": ("B7", _SRC, "emlight_tpu/nn/dense_conv_pallas.py:132"),   # _conv_kernel, fwd
    "dense_conv_dx": ("B7′", _SRC, "emlight_tpu/nn/dense_conv_pallas.py:132"),   # _conv_kernel, dx
    "dense_conv_dk": ("B8", _SRC, "emlight_tpu/nn/dense_conv_pallas.py:226"),    # _dk_kernel
}

_TILE_H, _TILE_W = 8, 32      # the kernels' output tile (TH, TW)
_DK_CIN, _DK_COUT = 48, 16    # B8's input and output channels per block
_DK_BLOCKS = 132              # B8: one block per SM of an H100
_DX_BLOCKS = 132              # B7, B7': one persistent block per SM of an H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(tensors: dict, dtype: torch.dtype, device) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _validate(x: torch.Tensor, cout: int, kernel: torch.Tensor | None = None,
              **vectors: torch.Tensor) -> None:
    """x (B, H, W, Cin) of a kernel dtype, the kernel (3, 3, Cin, Cout) in
    x's dtype, the per-channel vectors (Cin,) float32; all contiguous on x's
    device."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    _check({"x": x}, x.dtype, x.device)
    if kernel is not None:
        if tuple(kernel.shape) != (3, 3, cin, cout):
            raise ValueError(f"kernel must be (3, 3, {cin}, {cout}), got {tuple(kernel.shape)}")
        _check({"kernel": kernel}, x.dtype, x.device)
    for name, v in vectors.items():
        if tuple(v.shape) != (cin,):
            raise ValueError(f"{name} must be ({cin},), got {tuple(v.shape)}")
    _check(vectors, torch.float32, x.device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dense_conv_fwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   kernel: torch.Tensor) -> torch.Tensor:
    """conv3x3(x * a + b, kernel), SAME zero padding: x (B, H, W, Cin),
    kernel (3, 3, Cin, Cout) -> (B, H, W, Cout) f32.

    CPU tensor: ``conv3x3_nhwc_reference``. CUDA tensor: one launch of B7
    (``dx_blocks`` persistent blocks) on the current stream, counted in
    ``dense_conv_fwd.launches``.
    """
    if not on_cuda(x, "dense_conv_fwd"):
        from .dense_conv import conv3x3_nhwc_reference

        return conv3x3_nhwc_reference(x, a, b, kernel)
    cout = kernel.shape[-1]
    _validate(x, cout, kernel, a=a, b=b)
    bsz, h, w, cin = x.shape
    out = torch.empty(bsz, h, w, cout, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = entry("dense_conv", "dense_conv_fwd", x.dtype, 5, 6)(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), kernel.data_ptr(), out.data_ptr(),
            bsz, h, w, cin, cout, dx_blocks(bsz, h, w), _stream(x))
    raise_on(rc, "dense_conv_fwd", f"x {tuple(x.shape)} {x.dtype}, cout {cout}")
    dense_conv_fwd.launches += 1
    return out


def dense_conv_dx(g: torch.Tensor, x: torch.Tensor, a: torch.Tensor, kernel: torch.Tensor):
    """(dx (B, H, W, Cin), da (Cin,), db (Cin,)), all f32, from the cotangent
    g (B, H, W, Cout) of ``dense_conv_fwd``, its input x and the kernel.

    CPU tensor: ``conv3x3_dx_plain``. CUDA tensor: B7' (``dx_blocks``
    persistent blocks) and the fixed-order sum of its per-block da, db
    partials (two launches on the current stream), counted once in
    ``dense_conv_dx.launches``.
    """
    if not on_cuda(g, "dense_conv_dx"):
        from .dense_conv import conv3x3_dx_plain

        return conv3x3_dx_plain(g, x, a, kernel)
    cout = kernel.shape[-1]
    _validate(x, cout, kernel, a=a)
    bsz, h, w, cin = x.shape
    if tuple(g.shape) != (bsz, h, w, cout):
        raise ValueError(f"g {tuple(g.shape)} is not the output of x {tuple(x.shape)}")
    _check({"g": g}, x.dtype, x.device)
    n_blocks = dx_blocks(bsz, h, w)
    partial = torch.empty(2, n_blocks, cin, dtype=torch.float32, device=x.device)
    dx = torch.empty(bsz, h, w, cin, dtype=torch.float32, device=x.device)
    da = torch.empty(cin, dtype=torch.float32, device=x.device)
    db = torch.empty(cin, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = entry("dense_conv", "dense_conv_dx", x.dtype, 8, 6)(
            g.data_ptr(), x.data_ptr(), a.data_ptr(), kernel.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), da.data_ptr(), db.data_ptr(), bsz, h, w, cin, cout, n_blocks,
            _stream(x))
    raise_on(rc, "dense_conv_dx", f"g {tuple(g.shape)} {g.dtype}, cin {cin}")
    dense_conv_dx.launches += 1
    return dx, da, db


def dx_blocks(b: int, h: int, w: int) -> int:
    """The grid of B7 and B7′: one persistent block per SM, never more
    blocks than 8x32 tiles (a B7′ block sums dA, dB over the tiles it
    walks)."""
    return min(_DX_BLOCKS, b * _cdiv(h, _TILE_H) * _cdiv(w, _TILE_W))


def dk_chunks(n_tiles: int, cin: int, cout: int) -> tuple[int, int]:
    """(tiles per chunk, chunk count) of B8's split of its 8x32 pixel tiles
    into contiguous chunks: enough chunks that the (chunk, 48-channel cin
    block, 16-channel cout block) grid has about one block per SM (each
    holds 197 KB of shared memory), every chunk non-empty."""
    tiles = _cdiv(cin, _DK_CIN) * _cdiv(cout, _DK_COUT)
    want = max(1, min(_cdiv(_DK_BLOCKS, tiles), n_tiles))
    per = _cdiv(n_tiles, want)
    return per, _cdiv(n_tiles, per)


def dense_conv_dk(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """dK (3, 3, Cin, Cout) f32 of ``dense_conv_fwd`` from its input x
    (B, H, W, Cin), affine a, b and cotangent g (B, H, W, Cout), x and g in
    one dtype.

    CPU tensor: ``conv3x3_dk_plain``. CUDA tensor: ``dk_chunks``' per-chunk
    partials (an implicit GEMM on the tensor cores) and their sum in chunk
    order (two launches on the current stream), counted once in
    ``dense_conv_dk.launches``.
    """
    if not on_cuda(x, "dense_conv_dk"):
        from .dense_conv import conv3x3_dk_plain

        return conv3x3_dk_plain(x, g, a, b)
    if g.dim() != 4 or tuple(g.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"g {tuple(g.shape)} is not the output of x {tuple(x.shape)}")
    bsz, h, w, cin = x.shape
    cout = g.shape[3]
    _validate(x, cout, a=a, b=b)
    _check({"g": g}, x.dtype, x.device)
    per, n_chunks = dk_chunks(bsz * _cdiv(h, _TILE_H) * _cdiv(w, _TILE_W), cin, cout)
    partial = torch.empty(n_chunks, 9, cin, cout, dtype=torch.float32, device=x.device)
    dk = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = entry("dense_conv", "dense_conv_dk", x.dtype, 6, 7)(
            x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(), partial.data_ptr(),
            dk.data_ptr(), bsz, h, w, cin, cout, per, n_chunks, _stream(x))
    raise_on(rc, "dense_conv_dk", f"x {tuple(x.shape)} {x.dtype}, cout {cout}")
    dense_conv_dk.launches += 1
    return dk


for _fn in (dense_conv_fwd, dense_conv_dx, dense_conv_dk):
    _fn.launches = 0
del _fn
