"""The sphere conv's gradient: inverse tables, plain dx and dK, and the
autograd Function whose forward and backward are the hand-written kernels.

Port of emlight_tpu/nn/sphere_conv_vjp.py. The forward reads

    out[i, j] += w(i,t,k,j) * x[rows[i,t,k], (stride*j + s[i,t,k]) mod W] @ K_t

so its transpose is

- dx: U[t] = g @ K_tᵀ, then dx[r, (stride*j + s) mod W] += w * U[t][i][j]
  over the forward triples (i, t, k) whose source row is r. Grouped per input
  row (``inverse_tables``) or per input pixel (``_inverse_flat_tables``) the
  scatter becomes a gather of at most 64 terms. U is linear in g, so at
  stride 1 the sum regroups by tap: dx[r] = Σ_t Ĝ_t[r] K_tᵀ with Ĝ_t the
  weighted sum of g over the slots of (r, t) (``tap_grouped_tables``).
- dK[t] = Σ_pixels s_t(x)ᵀ g, with s_t the forward's per-tap sampled operand.
- dbias = Σ g.

Two implementations of dx and dK:
- ``dx_plain`` / ``dk_plain``: plain PyTorch (ports of ``_dx_gather_flat`` and
  ``_dk_gather``). They serve CPU tensors and are the oracles the CUDA
  kernels are checked against.
- the CUDA kernels B3/B6/B5 (dx: stride 1 on maps of at least / below
  ``UMAJOR_MIN_PIXELS``, B3 by the tap regrouping, B6 by a U GEMM and a
  gather; stride 2) and B4 (dK), through the wrappers in
  ``nn/sphere_conv_kernel.py``.

``SphereConvFunction`` ties forward and backward together; the wrappers pick
the kernel for a CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .sphere_conv import _taps_on, sphere_taps
from .sphere_conv_kernel import (
    scalar_weight_tables,
    sphere_conv_dk,
    sphere_conv_dx,
    sphere_conv_s1,
    sphere_conv_s2,
    structured_tables,
)

__all__ = ["inverse_tables", "tap_grouped_tables", "dx_plain", "dk_plain", "SphereConvFunction"]

_MAX_FANIN = 64  # padded (i, t, k) triple count per input row


@functools.lru_cache(maxsize=None)
def _inverse_flat_tables(h: int, w: int, stride: int = 1):
    """Per-INPUT-PIXEL inverse of the forward gather tables.

    For input pixel p: dx[p] = sum_m wv[p, m] * (g @ K_{tap}ᵀ)[src[p, m]]
    with src a flat index into the tap-major (9*P_out) axis.

    Returns (src (P_in, F) int32 into 9*P_out, wv (P_in, F) f32, fanin F).
    """
    idx, wgt, (ho, wo) = sphere_taps(h, w, stride)
    p_out = ho * wo
    entries: list[list[tuple[int, float]]] = [[] for _ in range(h * w)]
    for po in range(p_out):
        for t in range(9):
            for k in range(4):
                wv = float(wgt[po, t, k])
                if wv != 0.0:
                    entries[int(idx[po, t, k])].append((t * p_out + po, wv))
    fanin = max(1, max(len(e) for e in entries))
    src = np.zeros((h * w, fanin), np.int32)
    wv = np.zeros((h * w, fanin), np.float32)
    for p, e in enumerate(entries):
        for m, (s, v) in enumerate(e):
            src[p, m] = s
            wv[p, m] = v
    return src, wv, fanin


@functools.lru_cache(maxsize=None)
def inverse_tables(h: int, w: int, stride: int = 1):
    """Group forward triples by their source row.

    Returns (out_rows, taps, shifts, w0, jdev, fanin):
      out_rows (H, M) int32 — contributing output row (weight-0 pad slots
               point at the row's own output row r // stride)
      taps     (H, M) int32
      shifts   (H, M) int32 — column shift s: input col = (stride*j + s) mod W
      w0       (H, M) f32 — the forward's constant per-out-column weight
      jdev     (H, M) int32 — zero-padded output column, -1 if none (the
               per-column weight is where(col == jdev, 0, w0), exactly)
      fanin: max used M (<= 64)
    """
    rows_c, shift_c, wcol = structured_tables(h, w, stride)
    w0_tab, jdev_tab = scalar_weight_tables(h, w, stride)
    ho = rows_c.shape[0]
    per_row: list[list[tuple[int, int, int]]] = [[] for _ in range(h)]
    for i in range(ho):
        for t in range(9):
            for k in range(4):
                if wcol[i, t, k].any():
                    per_row[rows_c[i, t, k]].append((i, t, k))
    fanin = max(len(v) for v in per_row)
    assert fanin <= _MAX_FANIN, fanin
    m = fanin
    out_rows = np.repeat(
        np.clip(np.arange(h, dtype=np.int32) // stride, 0, ho - 1)[:, None], m, axis=1
    )
    taps = np.zeros((h, m), np.int32)
    shifts = np.zeros((h, m), np.int32)
    w0 = np.zeros((h, m), np.float32)
    jdev = np.full((h, m), -1, np.int32)
    for r in range(h):
        for j, (i, t, k) in enumerate(per_row[r]):
            out_rows[r, j] = i
            taps[r, j] = t
            shifts[r, j] = shift_c[i, t, k]
            w0[r, j] = w0_tab[i, t, k]
            jdev[r, j] = jdev_tab[i, t, k]
    return out_rows, taps, shifts, w0, jdev, fanin


@functools.lru_cache(maxsize=None)
def tap_grouped_tables(h: int, w: int):
    """The stride-1 ``inverse_tables`` grouped by tap: per (input row r,
    tap t) the slots of row r with tap t, in their order there (padded
    slots, w0 == 0, left out).

    Returns (counts, out_rows, shifts, w0, jdev, smax):
      counts   (H, 9) int32 — slots of (r, t)
      out_rows, shifts, jdev (H, 9, smax) int32 and w0 (H, 9, smax) f32 —
               the slots as inverse_tables has them (past counts[r, t]:
               out_row r, shift 0, w0 0, jdev -1)
      smax: the most slots of any (r, t)
    """
    orow, taps, shifts, w0, jdev, fanin = inverse_tables(h, w, 1)
    live = [[[m for m in range(fanin) if w0[r, m] != 0 and taps[r, m] == t] for t in range(9)]
            for r in range(h)]
    smax = max(1, max(len(ms) for row in live for ms in row))
    counts = np.zeros((h, 9), np.int32)
    g_orow = np.repeat(np.arange(h, dtype=np.int32)[:, None, None], 9 * smax, 1).reshape(h, 9, smax)
    g_shift = np.zeros((h, 9, smax), np.int32)
    g_w0 = np.zeros((h, 9, smax), np.float32)
    g_jdev = np.full((h, 9, smax), -1, np.int32)
    for r in range(h):
        for t in range(9):
            ms = live[r][t]
            counts[r, t] = len(ms)
            g_orow[r, t, :len(ms)] = orow[r, ms]
            g_shift[r, t, :len(ms)] = shifts[r, ms]
            g_w0[r, t, :len(ms)] = w0[r, ms]
            g_jdev[r, t, :len(ms)] = jdev[r, ms]
    return counts, g_orow, g_shift, g_w0, g_jdev, smax


@functools.lru_cache(maxsize=None)
def _flat_tables_on(h: int, w: int, stride: int, device: str):
    src, wv, fanin = _inverse_flat_tables(h, w, stride)
    return (torch.from_numpy(src.astype(np.int64)).to(device),
            torch.from_numpy(wv).to(device), fanin)


def dx_plain(g: torch.Tensor, kernel: torch.Tensor, x_shape, stride: int = 1) -> torch.Tensor:
    """dx (B, H, W, Cin) f32 from the cotangent g (B, Ho, Wo, Cout) and the
    kernel (3, 3, Cin, Cout), both read in g's dtype and computed in f32.

    U = g @ K_tᵀ for every tap, then the per-pixel gather over the flat
    inverse tables. Padded slots (weight 0) are masked out, not multiplied.
    """
    b, ho, wo, cout = g.shape
    h, w, cin = x_shape[1], x_shape[2], x_shape[3]
    src, wv, fanin = _flat_tables_on(h, w, stride, str(g.device))
    dt = g.dtype
    kf = kernel.reshape(9, cin, cout).to(dt).float()
    gf = g.reshape(b, ho * wo, cout).float()
    u = torch.einsum("bpd,tcd->btpc", gf, kf).reshape(b, 9 * ho * wo, cin)
    dx = torch.zeros(b, h * w, cin, dtype=torch.float32, device=g.device)
    for m in range(fanin):
        wm = wv[:, m][None, :, None]
        dx = dx + torch.where(wm != 0, u[:, src[:, m]] * wm, 0.0)
    return dx.reshape(b, h, w, cin)


def dk_plain(x: torch.Tensor, g: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """dK (3, 3, Cin, Cout) f32 from x (B, H, W, Cin) and the cotangent g
    (B, Ho, Wo, Cout): dK[t] = Σ s_t(x)ᵀ g.

    The sampled operand s_t is formed as the forward's plain version forms it
    (4-neighbour sum in f32, rounded once to x's dtype); g is read in x's
    dtype; the contraction accumulates in f32.
    """
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    _, _, (ho, wo) = sphere_taps(h, w, stride)
    idx_t, wgt_t = _taps_on(h, w, stride, str(x.device))
    dt = x.dtype
    xf = x.reshape(b, h * w, cin).float()
    gf = g.reshape(b, ho * wo, cout).to(dt).float()
    dk = []
    for t in range(9):
        s = 0.0
        for k in range(4):
            s = s + xf[:, idx_t[t, :, k]] * wgt_t[t, :, k][None, :, None]
        dk.append(torch.einsum("bpc,bpd->cd", s.to(dt).float(), gf))
    return torch.stack(dk).reshape(3, 3, cin, cout)


class SphereConvFunction(torch.autograd.Function):
    """Sphere conv with the hand-written kernels forward and backward.

    apply(x, kernel, bias, stride): x (B, H, W, Cin) f32/bf16 contiguous,
    kernel (3, 3, Cin, Cout) in x's dtype, bias (Cout,) f32 or None ->
    (B, H/stride, W/stride, Cout) f32.

    Forward: B1 (stride 1) or B2 (stride 2). Backward: dx by B3, B6 or B5 only if
    x needs a gradient, dK by B4 only if the kernel does, db = Σ g. The two
    checks do what XLA's dead-code elimination did in the JAX package: the
    SPADE ``mlp_shared`` convs read the constant guide and need no dx; a
    frozen discriminator needs no dK. The cotangent is read in x's dtype.
    """

    @staticmethod
    def forward(ctx, x, kernel, bias, stride):
        ctx.stride = stride
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, kernel)
        if stride == 1:
            return sphere_conv_s1(x, kernel, bias)
        if stride == 2:
            return sphere_conv_s2(x, kernel, bias)
        raise ValueError(f"sphere conv stride must be 1 or 2, got {stride}")

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        gc = g.to(x.dtype).contiguous()
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = sphere_conv_dx(gc, kernel, tuple(x.shape), ctx.stride).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = sphere_conv_dk(x, gc, ctx.stride).to(kernel.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dk, db, None
