"""Sinkhorn spherical-transport divergence (EMLight's anchor EMD loss).

Port of emlight_tpu/losses/sinkhorn.py; its ``axis_name`` is the port's
``group`` (a dist/mesh.py RankGroup), over whose ranks the data diameter is
taken. Same semantics as the reference's tensorized unbiased
Sinkhorn divergence (RegressionNetwork/geomloss/) and its GMLight geometric
variant:

- the ε-scaling loop runs on detached costs and log-weights (the reference
  wraps it in set_grad_enabled(False)); here a plain Python loop of tensor
  operations under torch.no_grad();
- gradients flow only through a final extrapolation step with differentiable
  costs and detached duals;
- with ``diameter=None`` the diameter comes from the batch (detached, plus
  1e-8) and the schedule has the fixed length ``n_iters``, clamped at blur^p
  (``_clamped_schedule``); a float ``diameter`` gives the reference's exact
  schedule (``epsilon_schedule``).

The JAX package has no Pallas kernel here (its fused loop was removed), so
neither has the port.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.geometry import geometric_points, sphere_points
from ..dist.mesh import global_extremum

__all__ = ["anchor_cost_matrix", "geometric_cost_matrix", "geometric_cost_matrix_tensor",
           "log_weights", "softmin", "epsilon_schedule", "sinkhorn_divergence", "SamplesLoss"]

_LOG_WEIGHT_FLOOR = -100000.0  # log_weights clamp (sinkhorn_divergence.py:47-50)


@functools.lru_cache(maxsize=None)
def _anchor_cost_matrix_cached(n: int) -> np.ndarray:
    a = sphere_points(n)
    return np.linalg.norm(a[:, None, :] - a[None, :, :], axis=-1).astype(np.float32)


def anchor_cost_matrix(n: int = 96) -> np.ndarray:
    """Pairwise anchor-to-anchor euclidean distances, (n, n) float32."""
    return _anchor_cost_matrix_cached(int(n))


def geometric_cost_matrix(n: int, anchor_depth) -> np.ndarray:
    """GMLight per-sample variant: anchors at the given depths, (n, n) float32."""
    a = geometric_points(n, anchor_depth)
    return np.linalg.norm(a[:, None, :] - a[None, :, :], axis=-1).astype(np.float32)


def geometric_cost_matrix_tensor(anchor_depth: torch.Tensor) -> torch.Tensor:
    """GMLight cost matrix from per-anchor depths given as a tensor:
    (N,) or (B, N) -> (N, N) or (B, N, N), in the depths' dtype and device.
    Same geometry as geometric_points: x, y scaled by depth, z on the unit
    golden-spiral profile."""
    n = anchor_depth.shape[-1]
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    kw = dict(dtype=anchor_depth.dtype, device=anchor_depth.device)
    theta = torch.as_tensor(golden_angle * np.arange(n), **kw)
    z = torch.as_tensor(np.linspace(1 - 1.0 / n, 1.0 / n - 1, n), **kw)
    pts = torch.stack([anchor_depth * torch.cos(theta), anchor_depth * torch.sin(theta),
                       z.expand(anchor_depth.shape)], dim=-1)  # (..., N, 3)
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))


def log_weights(alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(alpha > 0, torch.log(torch.where(alpha > 0, alpha, 1.0)),
                       _LOG_WEIGHT_FLOOR)


def softmin(eps, c: torch.Tensor, wlog: torch.Tensor) -> torch.Tensor:
    """-ε·logsumexp(wlog - C/ε) over the last axis: C (..., N, M), wlog
    (..., M) -> (..., N)."""
    return -eps * torch.logsumexp(wlog[..., None, :] - c / eps, dim=-1)


def epsilon_schedule(p: float, diameter: float, blur: float, scaling: float) -> np.ndarray:
    """The reference's exact schedule (sinkhorn_divergence.py:21-25), float32."""
    eps_s = (
        [diameter**p]
        + [math.exp(e) for e in
           np.arange(p * math.log(diameter), p * math.log(blur), p * math.log(scaling))]
        + [blur**p]
    )
    return np.asarray(eps_s, dtype=np.float32)


def _clamped_schedule(diameter: torch.Tensor, p: float, blur: float, scaling: float,
                      n_iters: int) -> torch.Tensor:
    """Schedule of static length n_iters for a diameter taken from the data."""
    i = torch.arange(n_iters - 2, dtype=torch.float32, device=diameter.device)
    mid = torch.clamp(diameter * (scaling**i).to(diameter.dtype), min=blur) ** p
    ends = [diameter.reshape(1) ** p, mid,
            torch.tensor([blur**p], dtype=mid.dtype, device=diameter.device)]
    return torch.cat(ends)


def _sinkhorn_loop(alpha_log, beta_log, c_xx, c_yy, c_xy, c_yx, eps_s):
    """ε-scaling loop on detached inputs, then the differentiable final
    extrapolation (sinkhorn_divergence.py:72-109, balanced case). Returns
    (a_x, b_y, a_y, b_x)."""
    with torch.no_grad():
        s_alog, s_blog = alpha_log.detach(), beta_log.detach()
        s_xx, s_yy, s_xy, s_yx = (c.detach() for c in (c_xx, c_yy, c_xy, c_yx))
        eps0 = eps_s[0]
        a_x = softmin(eps0, s_xx, s_alog)
        b_y = softmin(eps0, s_yy, s_blog)
        a_y = softmin(eps0, s_yx, s_alog)
        b_x = softmin(eps0, s_xy, s_blog)
        for eps in eps_s:
            at_x = softmin(eps, s_xx, s_alog + a_x / eps)
            bt_y = softmin(eps, s_yy, s_blog + b_y / eps)
            at_y = softmin(eps, s_yx, s_alog + b_x / eps)
            bt_x = softmin(eps, s_xy, s_blog + a_y / eps)
            a_x, b_y = 0.5 * (a_x + at_x), 0.5 * (b_y + bt_y)
            a_y, b_x = 0.5 * (a_y + at_y), 0.5 * (b_x + bt_x)
    # last extrapolation: duals detached, costs differentiable
    eps = eps_s[-1]
    a_x_f = softmin(eps, c_xx, (alpha_log + a_x / eps).detach())
    b_y_f = softmin(eps, c_yy, (beta_log + b_y / eps).detach())
    a_y_f = softmin(eps, c_yx, (alpha_log + b_x / eps).detach())
    b_x_f = softmin(eps, c_xy, (beta_log + a_y / eps).detach())
    return a_x_f, b_y_f, a_y_f, b_x_f


def _scal(alpha: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return (alpha.reshape(alpha.shape[0], -1) * f.reshape(f.shape[0], -1)).sum(1)


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, *,
                        cost_matrix: torch.Tensor | None = None,
                        alpha: torch.Tensor | None = None, beta: torch.Tensor | None = None,
                        p: float = 2.0, blur: float = 0.025, scaling: float = 0.5,
                        diameter: float | None = None, n_iters: int = 12,
                        value_weight: float = 0.1, group=None) -> torch.Tensor:
    """Unbiased Sinkhorn divergence S_ε(α, β) between anchored histograms.

    Cost C(x_i, y_j) = (value_weight·(x_i - y_j)² + M_ij) / 2 with M the
    anchor-distance matrix and the second argument of each pairwise cost
    detached. x, y: (B, N[, 1]); alpha, beta default uniform; diameter a
    float for the exact reference schedule, None for the data's diameter with
    the fixed-length clamped schedule; with a ``group`` that diameter is the
    global batch's (a min and a max over the ranks, without a gradient, as
    the reference takes it under no_grad). Returns (B,) divergences.
    """
    b = x.shape[0]
    x = x.reshape(b, -1)
    y = y.reshape(b, -1)
    n, m = x.shape[1], y.shape[1]
    if cost_matrix is None:
        if n != m:
            raise ValueError("x and y must share the anchor set")
        cost_matrix = torch.from_numpy(anchor_cost_matrix(n))
    cost_matrix = cost_matrix.to(x.device)
    if alpha is None:
        alpha = torch.full((b, n), 1.0 / n, dtype=x.dtype, device=x.device)
    if beta is None:
        beta = torch.full((b, m), 1.0 / m, dtype=y.dtype, device=y.device)

    def cost(u, v):
        sq = (u[..., :, None] - v.detach()[..., None, :]) ** 2
        return (sq * value_weight + cost_matrix) * 0.5

    c_xx, c_yy, c_xy, c_yx = cost(x, x), cost(y, y), cost(x, y), cost(y, x)
    if diameter is None:
        lo = global_extremum(torch.minimum(x.min(), y.min()), group, True)
        hi = global_extremum(torch.maximum(x.max(), y.max()), group, False)
        d = (hi - lo).abs().detach() + 1e-8
        eps_s = _clamped_schedule(d, p, blur, scaling, n_iters)
    else:
        eps_s = torch.from_numpy(epsilon_schedule(p, float(diameter), blur, scaling)).to(x.device)
    a_x, b_y, a_y, b_x = _sinkhorn_loop(log_weights(alpha), log_weights(beta),
                                        c_xx, c_yy, c_xy, c_yx, eps_s)
    return _scal(alpha, b_x - a_x) + _scal(beta, a_y - b_y)


class SamplesLoss:
    """The reference's geomloss.SamplesLoss API, sinkhorn branch:

        loss = SamplesLoss("sinkhorn", p=2, blur=.025)
        values = loss(dist_pred, dist_gt)   # (B,)

    n_anchors picks the anchor cost matrix (96 for EMLight's regression loss,
    128 for GMLight); ``geometry`` (per-anchor depths) the GMLight variant;
    ``group`` (a dist/mesh.py RankGroup) the ranks whose global batch the
    diameter is taken over (the JAX package's ``axis_name``, which names a
    JAX mesh axis and is refused here).
    """

    def __init__(self, loss: str = "sinkhorn", p: float = 2.0, blur: float = 0.05,
                 reach=None, diameter: float | None = None, scaling: float = 0.5,
                 batchsize: int | None = None, n_anchors: int = 96, n_iters: int = 12,
                 backend: str = "auto", geometry=None, axis_name: str | None = None,
                 group=None):
        if loss != "sinkhorn":
            raise NotImplementedError("only the sinkhorn branch exists in the reference")
        if reach is not None:
            raise NotImplementedError("reference always runs balanced OT (reach=None)")
        if axis_name is not None:
            raise NotImplementedError("axis_name names a JAX mesh axis: pass group, a "
                                      "dist/mesh.py RankGroup")
        if backend != "auto":
            raise ValueError(f"unknown backend {backend!r}: the port has one loop ('auto')")
        self.p, self.blur, self.scaling = p, blur, scaling
        self.diameter = diameter
        self.n_iters = n_iters
        self.group = group
        m = (geometric_cost_matrix(n_anchors, geometry) if geometry is not None
             else anchor_cost_matrix(n_anchors))
        self.M = torch.from_numpy(m)

    def __call__(self, x: torch.Tensor, y: torch.Tensor, geometry=None) -> torch.Tensor:
        """geometry: optional (N,) or (B, N) anchor depths as a tensor -> the
        GMLight cost matrix built from them."""
        if geometry is not None:
            m = geometric_cost_matrix_tensor(torch.as_tensor(geometry, device=x.device))
        else:
            m = self.M
        return sinkhorn_divergence(x, y, cost_matrix=m, p=self.p, blur=self.blur,
                                   scaling=self.scaling, diameter=self.diameter,
                                   n_iters=self.n_iters, group=self.group)
