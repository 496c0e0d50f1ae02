"""Real/complex spherical harmonics, vectorized (healpy/scipy-lpmn-free on the
hot path).

The port's own copy of emlight_tpu/needlets/harmonics.py (the port imports
nothing of the JAX package): the same NumPy float64 arithmetic, so the same
bits.

Parity targets: Needlets/sphere_harmonics.py —
- SH (real basis, K-normalized, Condon-Shortley in P):   :14-58
- shEvaluate grid basis:                                  :60-70
- spharmonic_eval (complex Y_lm):                         :77-89
- spharmonic (symmetrized real basis matrix):             :94-115

The associated Legendre functions use the standard stable (l-1, l-2)
recurrence, vectorized over evaluation points; normalizations use log-gamma
instead of factorials so lmax can exceed 85 without overflow.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

__all__ = [
    "legendre_all",
    "sh_index",
    "sh_terms",
    "real_sh",
    "real_sh_matrix",
    "complex_sh",
    "symmetrized_sh_matrix",
    "legendre_poly",
]


def sh_index(l: int, m: int) -> int:
    return l * l + l + m


def sh_terms(lmax: int) -> int:
    return (lmax + 1) * (lmax + 1)


def legendre_all(lmax: int, x: np.ndarray) -> np.ndarray:
    """Associated Legendre P_l^m(x) with Condon-Shortley phase.

    Returns (lmax+1, lmax+1, *x.shape): entry [l, m] valid for m <= l.
    """
    x = np.asarray(x, dtype=np.float64)
    P = np.zeros((lmax + 1, lmax + 1) + x.shape)
    P[0, 0] = 1.0
    if lmax == 0:
        return P
    somx2 = np.sqrt(np.clip((1.0 - x) * (1.0 + x), 0.0, None))
    # diagonal: P_m^m = (-1)^m (2m-1)!! (1-x^2)^{m/2}
    for m in range(1, lmax + 1):
        P[m, m] = -(2 * m - 1) * somx2 * P[m - 1, m - 1]
    # first off-diagonal: P_{m+1}^m = x (2m+1) P_m^m
    for m in range(0, lmax):
        P[m + 1, m] = x * (2 * m + 1) * P[m, m]
    # upward recurrence in l
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            P[l, m] = ((2 * l - 1) * x * P[l - 1, m] - (l + m - 1) * P[l - 2, m]) / (l - m)
    return P


def _k_norm(l: np.ndarray, m: np.ndarray) -> np.ndarray:
    """K_l^m = sqrt((2l+1)/(4π) (l-m)!/(l+m)!) via log-gamma."""
    return np.sqrt(
        (2 * l + 1) / (4 * np.pi) * np.exp(gammaln(l - m + 1) - gammaln(l + m + 1))
    )


def real_sh(l: int, m: int, theta, phi) -> np.ndarray:
    """Real SH with the reference's `SH` convention (sphere_harmonics.py:48-58):
    m>0 -> √2 K cos(mφ) P_l^m, m<0 -> √2 K sin(|m|φ) P_l^|m|."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    am = abs(m)
    P = legendre_all(l, np.cos(theta))[l, am]
    K = _k_norm(np.float64(l), np.float64(am))
    if m == 0:
        return K * P * np.ones_like(phi)
    if m > 0:
        return np.sqrt(2.0) * K * np.cos(m * phi) * P
    return np.sqrt(2.0) * K * np.sin(am * phi) * P


def real_sh_matrix(theta: np.ndarray, phi: np.ndarray, lmax: int) -> np.ndarray:
    """All real SH (the `shEvaluate` basis) at points: (N, (lmax+1)^2)."""
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    phi = np.asarray(phi, dtype=np.float64).reshape(-1)
    P = legendre_all(lmax, np.cos(theta))  # (L+1, L+1, N)
    out = np.zeros((theta.size, sh_terms(lmax)))
    sqrt2 = np.sqrt(2.0)
    for l in range(lmax + 1):
        for m in range(0, l + 1):
            K = _k_norm(np.float64(l), np.float64(m))
            if m == 0:
                out[:, sh_index(l, 0)] = K * P[l, 0]
            else:
                out[:, sh_index(l, m)] = sqrt2 * K * np.cos(m * phi) * P[l, m]
                out[:, sh_index(l, -m)] = sqrt2 * K * np.sin(m * phi) * P[l, m]
    return out


def complex_sh(l: int, m: int, theta, phi) -> np.ndarray:
    """Complex Y_lm (spharmonic_eval, sphere_harmonics.py:77-89)."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    am = abs(m)
    P = legendre_all(l, np.cos(theta))[l, am]
    C = _k_norm(np.float64(l), np.float64(am))
    Y = C * P * np.exp(1j * am * phi)
    if m < 0:
        Y = (-1) ** am * np.conjugate(Y)
    return Y


def symmetrized_sh_matrix(theta: np.ndarray, phi: np.ndarray, lmax: int) -> np.ndarray:
    """The `spharmonic` basis (sphere_harmonics.py:94-115): per (l, m),
    m<0 -> √2 Re(Y_l|m|) [sign telescopes to +], m=0 -> Y_l0,
    m>0 -> (-1)^m √2 Im(Y_lm). Shape (N, (lmax+1)^2)."""
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    phi = np.asarray(phi, dtype=np.float64).reshape(-1)
    P = legendre_all(lmax, np.cos(theta))
    out = np.zeros((theta.size, sh_terms(lmax)))
    sqrt2 = np.sqrt(2.0)
    for l in range(lmax + 1):
        for m in range(0, l + 1):
            K = _k_norm(np.float64(l), np.float64(m))
            if m == 0:
                out[:, sh_index(l, 0)] = K * P[l, 0]
            else:
                out[:, sh_index(l, -m)] = sqrt2 * K * np.cos(m * phi) * P[l, m]
                out[:, sh_index(l, m)] = (-1) ** m * sqrt2 * K * np.sin(m * phi) * P[l, m]
    return out


def legendre_poly(lmax: int, x: np.ndarray) -> np.ndarray:
    """Plain Legendre polynomials P_l(x), (lmax+1, *x.shape) — the addition-
    theorem workhorse for building needlet basis matrices."""
    x = np.asarray(x, dtype=np.float64)
    P = np.zeros((lmax + 1,) + x.shape)
    P[0] = 1.0
    if lmax >= 1:
        P[1] = x
    for l in range(2, lmax + 1):
        P[l] = ((2 * l - 1) * x * P[l - 1] - (l - 1) * P[l - 2]) / l
    return P
