"""Image-grid Sinkhorn OT (the reference's legacy SinkhornDistance,
RegressionNetwork/util.py:311-351): balanced entropic transport between two
images treated as histograms over pixel coordinates, via the classic
matrix-scaling (u/v) iterations on K = exp(-M/reg).

Port of emlight_tpu/losses/image_ot.py. The JAX package runs the scaling
loop as a lax.fori_loop with its (P, P) kernel matmuls left to XLA; here
they are ``torch.matmul``s inside ``full_f32_matmul`` (no TF32 on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..nn.layers import full_f32_matmul

__all__ = ["image_sinkhorn"]


@functools.lru_cache(maxsize=None)
def _coord_cost(h: int, w: int) -> np.ndarray:
    ys = np.linspace(0, 1, h)
    xs = np.linspace(0, 1, w)
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([Y.reshape(-1), X.reshape(-1)], axis=1)
    sq = (coords**2).sum(1)
    M = sq[:, None] + sq[None, :] - 2 * coords @ coords.T
    return np.maximum(M, 0.0).astype(np.float32)


def image_sinkhorn(a: torch.Tensor, b: torch.Tensor, reg: float = 1.0,
                   max_iter: int = 5) -> torch.Tensor:
    """OT cost between (B, C, H, W) image histograms (util.py:329-351 semantics).

    a, b should be positive; the reference does not normalize them and neither
    does the port. Returns a (B, C) transport-cost matrix (one scalar per
    batch/channel pair; the caller means). Runs on a's device.
    """
    bsz, c, h, w = a.shape
    dim = h * w
    M = torch.from_numpy(_coord_cost(h, w)).to(a.device)
    K = torch.exp(-M / reg)  # (P, P)
    av = a.reshape(bsz, c, dim)
    bv = b.reshape(bsz, c, dim)
    u = torch.full((bsz, c, dim), 1.0 / dim, dtype=a.dtype, device=a.device)
    v = u.clone()
    with full_f32_matmul():
        for _ in range(max_iter):
            # v_{t+1} = b / (K^T u_t); u_{t+1} = a / (K v_{t+1})  (util.py:344-348,
            # with the reference's Kp = (1/a)*K folded into u = a/(K v))
            v = bv / torch.matmul(u, K)
            u = av / torch.matmul(v, K.T)
        # cost_{bc} = sum_pq u_p K_pq v_q M_pq (the reference's final einsum :350)
        return (torch.matmul(u, K * M) * v).sum(-1)
