"""Direct spherical-Gaussian fitting to a panorama (RegressionNetwork/
panorama.py capability).

Port of emlight_tpu/representation/fit.py: K light directions, sizes and
colours + an ambient term fitted to one panorama by Adam (optax.adam's
arithmetic and order of operations: b1 0.9, b2 0.999, eps 1e-8) on the MSE through the splat
rasterizer (representation/splat.py::render_sg). The JAX package runs the
loop as one lax.scan; here it is a Python loop whose per-step loss and
gradient norm stay on the device and are stacked once at the end, so no
step waits for the host.

JAX draws the initial directions and colours with jax.random, whose bits
torch cannot draw: the port draws them from a torch.Generator seeded with
`seed`, or takes them as ``init`` (the tests feed JAX's draw).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..train.optim import global_norm
from .splat import render_sg

__all__ = ["fit_spherical_gaussians", "initial_params"]


def _render_params(params: dict, h: int, w: int) -> torch.Tensor:
    dirs = params["dirs_raw"]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    sizes = torch.exp(params["log_sizes"])
    colors = F.softplus(params["colors_raw"])
    env = render_sg(dirs[None], sizes[None], colors[None], h=h, w=w)[0]
    return env + F.softplus(params["ambient_raw"])[None, None, :]


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def _adam_update(params, grads, mu, nu, t: int, lr: float) -> None:
    """optax.adam(lr)'s update, in its order of operations, in place: the
    moments, their bias corrections at count t (a host integer: no sync)
    and p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)."""
    bc1 = np.float32(1) - np.float32(_B1) ** np.int32(t)
    bc2 = np.float32(1) - np.float32(_B2) ** np.int32(t)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_((1 - _B1) * g + _B1 * m)
        v.copy_((1 - _B2) * (g * g) + _B2 * v)
        p.add_((m / float(bc1)) / (torch.sqrt(v / float(bc2)) + _EPS) * -lr)


def initial_params(n_lights: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The fit's starting point as the JAX package lays it out: directions
    N(0, 1), log sizes log(0.05), colours N(1, 0.1²), zero ambient; the
    normals from a torch.Generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "dirs_raw": torch.randn(n_lights, 3, generator=gen).numpy(),
        "log_sizes": np.full((n_lights,), math.log(0.05), np.float32),
        "colors_raw": (torch.randn(n_lights, 3, generator=gen) * 0.1 + 1.0).numpy(),
        "ambient_raw": np.zeros((3,), np.float32),
    }


def fit_spherical_gaussians(pano, n_lights: int = 3, steps: int = 500, lr: float = 1e-2,
                            seed: int = 0, init: dict | None = None, device=None):
    """Fit n_lights spherical Gaussians + ambient to one (H, W, 3) panorama
    (a tensor, or an array taken to `device`: CUDA unless "cpu" is asked; a
    tensor stays where it is).

    Returns (params, env, metrics): fitted {dirs, sizes, colors, ambient},
    the final rendered env map, and per-step {loss, grad_norm} tensors of
    length `steps`. ``init``: the raw starting parameters (``initial_params``'
    layout; arrays, or tensors on the device), drawn from `seed` when None.
    """
    if isinstance(pano, torch.Tensor):
        dev = pano.device
    else:
        dev = resolve_device(device)
        pano = torch.tensor(np.asarray(pano, np.float32), device=dev)
    h, w, _ = pano.shape
    raw0 = initial_params(n_lights, seed) if init is None else init
    raw = {k: (v.detach().to(dev, torch.float32).clone() if isinstance(v, torch.Tensor)
               else torch.tensor(np.asarray(v, np.float32), device=dev)).requires_grad_(True)
           for k, v in raw0.items()}
    params = list(raw.values())
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses, norms = [], []
    for t in range(1, steps + 1):
        loss = torch.mean((_render_params(raw, h, w) - pano) ** 2)
        grads = torch.autograd.grad(loss, params)
        norms.append(global_norm(grads))
        losses.append(loss.detach())
        _adam_update(params, grads, mu, nu, t, lr)

    with torch.no_grad():
        dirs = raw["dirs_raw"] / torch.linalg.vector_norm(raw["dirs_raw"], dim=-1, keepdim=True)
        fitted = {
            "dirs": dirs,
            "sizes": torch.exp(raw["log_sizes"]),
            "colors": F.softplus(raw["colors_raw"]),
            "ambient": F.softplus(raw["ambient_raw"]),
        }
        env = _render_params(raw, h, w)
    return fitted, env, {"loss": torch.stack(losses), "grad_norm": torch.stack(norms)}
