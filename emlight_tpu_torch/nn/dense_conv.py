"""The dense layer's norm2 -> conv2: conv3x3(x * a + b, K) with the BatchNorm
affine fused into the conv's read, its plain versions and its autograd
Function.

Port of emlight_tpu/nn/dense_conv_pallas.py (``conv3x3_nhwc_reference``,
``fused_affine_conv3x3``). Layout NHWC, SAME zero padding of y = x * a + b:
the border is 0, not b. a and b are the per-channel train-mode BatchNorm
affine (nn/layers.py::BatchNorm.train_affine); the kernel is HWIO
(3, 3, Cin, Cout).

- ``conv3x3_nhwc_reference``: the forward's plain version (y rounded to x's
  dtype, then F.conv2d).
- ``conv3x3_dx_plain``, ``conv3x3_dk_plain``: the backward's plain versions
  as nine shifted tap products, the arithmetic of the kernels B7' and B8.
- ``fused_affine_conv3x3``: forward B7, backward B7' (dx, da, db) and B8
  (dK) through the wrappers in nn/dense_conv_kernel.py, which take these
  plain versions for CPU tensors. Unlike the JAX kernels (``supported()``,
  h % 8 == 0), every H, W >= 1 is handled.

The plain versions compute in float32, or in float64 for float64 inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dense_conv_kernel import dense_conv_dk, dense_conv_dx, dense_conv_fwd

__all__ = ["conv3x3_nhwc_reference", "conv3x3_dx_plain", "conv3x3_dk_plain",
           "FusedAffineConv3x3", "fused_affine_conv3x3"]


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = x * a + b computed in a's type, rounded to x's dtype, returned in
    the compute type (the JAX reference's dtype flow)."""
    ct = _compute_dtype(x.dtype)
    y = (x.to(a.dtype) * a + b).to(x.dtype)
    return y.to(ct)


def conv3x3_nhwc_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                           kernel: torch.Tensor) -> torch.Tensor:
    """conv3x3(x * a + b, kernel), SAME zero padding, NHWC: x (B, H, W, Cin),
    a, b (Cin,), kernel (3, 3, Cin, Cout) -> (B, H, W, Cout) in the compute
    type. y and the kernel are rounded to x's dtype first."""
    y = _affine(x, a, b)
    k = kernel.to(x.dtype).to(y.dtype)
    out = F.conv2d(y.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def conv3x3_dx_plain(g: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     kernel: torch.Tensor):
    """(dx, da, db) of conv3x3_nhwc_reference from its cotangent g
    (B, H, W, Cout): dy2 = Σ_t g[q - off_t] K_tᵀ, dx = dy2 * a, db = Σ dy2,
    da = Σ dy2 * x (the original x). g and the kernel are read in g's dtype."""
    ct = _compute_dtype(g.dtype)
    _, h, w, _ = g.shape
    gp = F.pad(g.to(ct), (0, 0, 1, 1, 1, 1))
    k = kernel.to(g.dtype).to(ct)
    dy2 = sum(torch.einsum("bhwo,co->bhwc", gp[:, 2 - ky:2 - ky + h, 2 - kx:2 - kx + w], k[ky, kx])
              for ky in range(3) for kx in range(3))
    return dy2 * a.to(ct), (dy2 * x.to(ct)).sum((0, 1, 2)), dy2.sum((0, 1, 2))


def conv3x3_dk_plain(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """dK (3, 3, Cin, Cout) of conv3x3_nhwc_reference: dK[t] = Σ_p
    y[p + off_t]ᵀ g[p], y as the forward forms it (zero border), g read in
    x's dtype."""
    _, h, w, _ = x.shape
    yp = F.pad(_affine(x, a, b), (0, 0, 1, 1, 1, 1))
    gf = g.to(x.dtype).to(yp.dtype)
    return torch.stack([
        torch.stack([torch.einsum("bhwc,bhwo->co", yp[:, ky:ky + h, kx:kx + w], gf)
                     for kx in range(3)])
        for ky in range(3)])


class FusedAffineConv3x3(torch.autograd.Function):
    """conv3x3(x * a + b, K) with the hand-written kernels forward and backward.

    apply(x, a, b, kernel): x (B, H, W, Cin) f32/bf16 contiguous, a and b
    (Cin,) f32, kernel (3, 3, Cin, Cout) in x's dtype -> (B, H, W, Cout) in
    x's dtype. Forward: B7. Backward: dx, da and db by B7' if any of x, a, b
    needs a gradient, dK by B8 if the kernel does. The cotangent is read in
    x's dtype.
    """

    @staticmethod
    def forward(ctx, x, a, b, kernel):
        ctx.save_for_backward(x, a, b, kernel)
        return dense_conv_fwd(x, a, b, kernel).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, a, b, kernel = ctx.saved_tensors
        gc = g.to(x.dtype).contiguous()
        dx = da = db = dk = None
        if any(ctx.needs_input_grad[:3]):
            dx, da, db = dense_conv_dx(gc, x, a, kernel)
            dx, da, db = dx.to(x.dtype), da.to(a.dtype), db.to(b.dtype)
        if ctx.needs_input_grad[3]:
            dk = dense_conv_dk(x, gc, a, b).to(kernel.dtype)
        return dx, da, db, dk


def fused_affine_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         kernel: torch.Tensor) -> torch.Tensor:
    """conv3x3(x * a + b, kernel), SAME zero padding, NHWC, differentiable in
    all four arguments (``FusedAffineConv3x3``); x and the kernel are made
    contiguous, the kernel cast to x's dtype."""
    return FusedAffineConv3x3.apply(x.contiguous(), a.contiguous(), b.contiguous(),
                                    kernel.to(x.dtype).contiguous())
