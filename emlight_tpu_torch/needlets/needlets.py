"""Mexican-needlet frequency basis on the sphere (ICCV 2021 Sparse Needlets).

Port of emlight_tpu/needlets/needlets.py, NumPy float64 as there. One change
of memory, none of arithmetic: ``needlet_basis_matrix`` sums each band's
windowed Legendre series inside the three-term recurrence, holding
P_{l-1} and P_{l-2} of a block of grid rows, where the JAX package
materialises ``legendre_poly(lmax, dots)`` as an (lmax+1, N, K) array (3.4
GB of host memory for the jmax 3 top band at 128x256). The terms are added
in the same l order with the same factors, so the basis is the same bits.

Parity targets: Needlets/sphere_needlets.py —
- window b via smooth bump quadrature (fun_b/compute_f2/f3):    :10-29
- needlet evaluation / basis matrix SNvertex:                    :34-104,196-238
- antipodal cubature pairing spneedlet_pair:                     :107-128
- SH->SN change of basis Ctran/Ctran_asymm:                      :243-297

KEY REDESIGN (the reference's SNvertex runs per-grid-point inverse SH
transforms — printed progress per point, days for a 32768-point grid). By the
spherical-harmonic addition theorem, the needlet centered at cubature point
ξ_jk evaluated at x is

    ψ_jk(x) = sqrt(λ_j) · Σ_l b(l/B^j) (2l+1)/(4π) P_l(ξ_jk · x)

i.e. a Legendre-polynomial series of the dot-product matrix — the ENTIRE
basis matrix is one (grid x cubature) matmul plus a vectorized polynomial
evaluation. Seconds instead of days, identical numerics.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy.integrate import quad

from .harmonics import complex_sh, symmetrized_sh_matrix
from .healpix import nside2npix, pix2vec

__all__ = [
    "needlet_window",
    "band_nside",
    "cubature_points",
    "needlet_basis_matrix",
    "cubature_pairing",
    "sh_to_needlet_matrix",
    "band_slices",
    "spherical_sampling",
]


@functools.lru_cache(maxsize=None)
def _bump_cdf_norm() -> float:
    return quad(lambda t: np.exp(-1.0 / (1.0 - t * t)), -1, 1)[0]


@functools.lru_cache(maxsize=None)
def _f2(u: float) -> float:
    return quad(lambda t: np.exp(-1.0 / (1.0 - t * t)), -1, u + 1e-10)[0] / _bump_cdf_norm()


def _f3(x: float, b: float) -> float:
    if x < 0:
        raise ValueError("x must be >= 0")
    if x <= 1.0 / b:
        return 1.0
    if x <= 1.0:
        return _f2(1.0 - 2.0 * b / (b - 1.0) * (x - 1.0 / b))
    return 0.0


def needlet_window(x: float, b: float = 2.0) -> float:
    """b(x) = sqrt(f3(x/B) - f3(x)) — smooth Littlewood-Paley window with
    partition of unity Σ_j b²(l/B^j) = 1 for l >= 1."""
    return math.sqrt(max(_f3(x / b, b) - _f3(x, b), 0.0))


def band_nside(j: int, b: float = 2.0) -> int:
    """Nside >= floor(B^{j+1})/2 rounded up to a power of two
    (sphere_needlets.py:48)."""
    return 2 ** math.ceil(math.log2(max(math.floor(b ** (j + 1)) / 2.0, 1.0)))


def cubature_points(jmax: int, b: float = 2.0) -> list[np.ndarray]:
    """Per-band HEALPix RING cubature point sets [(Npix_j, 3)]."""
    out = []
    for j in range(jmax + 1):
        ns = band_nside(j, b)
        out.append(pix2vec(ns, np.arange(nside2npix(ns))))
    return out


def band_slices(jmax: int, b: float = 2.0) -> list[slice]:
    """Column ranges of each band in the basis matrix (after the leading
    constant column): jmax=2 -> [1:13, 13:61, 61:253] (gt_gen_j2.py:47-66)."""
    out = []
    start = 1
    for j in range(jmax + 1):
        n = nside2npix(band_nside(j, b))
        out.append(slice(start, start + n))
        start += n
    return out


@functools.lru_cache(maxsize=None)
def _window_vector(j: int, lmax: int, b: float, bw: float) -> np.ndarray:
    return np.array([needlet_window(l / bw ** j, bw) for l in range(1, lmax + 1)])


_ROWS_PER_BLOCK = 4096  # grid rows whose recurrence runs together (elementwise: any count)


def _band_sum(dots: np.ndarray, l_st: int, l_en: int, w: np.ndarray) -> np.ndarray:
    """Σ_{l=l_st..l_en} w[l-1] (2l+1)/(4π) P_l(dots), with P_l from
    ``legendre_poly``'s recurrence kept two terms deep: the same operations
    on the same values as summing over ``legendre_poly(lmax, dots)[l]``."""
    band = np.zeros_like(dots)
    p_prev2 = np.ones_like(dots)  # P_0
    p_prev = dots.copy()          # P_1
    for l in range(1, l_en + 1):
        if l == 1:
            p_l = p_prev
        else:
            p_l = ((2 * l - 1) * dots * p_prev - (l - 1) * p_prev2) / l
            p_prev2, p_prev = p_prev, p_l
        if l >= l_st:
            band += w[l - 1] * (2 * l + 1) / (4 * np.pi) * p_l
    return band


def needlet_basis_matrix(theta: np.ndarray, phi: np.ndarray, jmax: int,
                         b: float = 2.0) -> np.ndarray:
    """SN matrix: (len(theta), 1 + Σ_j Npix_j); column 0 is Y_00.

    Matches SNvertex's third return (the full unsymmetrized matrix used by
    gt_gen_j2/j3 and mat_gen2). Note the reference evaluates the window at
    BW=2.0 regardless of B (sphere_needlets.py:39) and limits each band to
    l ∈ [ceil(B^{j-1}), min(floor(B^{j+1}), lmax)] with lmax = floor(B^{jmax+1})
    (sphere_needlets.py:73-74,185). Each band's series is summed in blocks
    of grid rows inside the recurrence (``_band_sum``): no (lmax+1, N, K)
    array.
    """
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    phi = np.asarray(phi, dtype=np.float64).reshape(-1)
    st = np.sin(theta)
    grid = np.stack((st * np.cos(phi), st * np.sin(phi), np.cos(theta)), axis=-1)

    lmax = int(np.floor(b ** (jmax + 1)))
    cols = [np.full((grid.shape[0], 1), complex_sh(0, 0, 0.0, 0.0).real)]
    for j in range(jmax + 1):
        ns = band_nside(j, b)
        pts = pix2vec(ns, np.arange(nside2npix(ns)))  # (K, 3)
        lam = 4.0 * np.pi / nside2npix(ns)
        dots = np.clip(grid @ pts.T, -1.0, 1.0)  # (N, K)
        l_st = int(np.ceil(b ** (j - 1)))
        l_en = int(min(np.floor(b ** (j + 1)), lmax))
        w = _window_vector(j, lmax, b, 2.0)  # BW hardcoded to 2.0 upstream
        band = np.empty_like(dots)
        for r in range(0, dots.shape[0], _ROWS_PER_BLOCK):
            band[r:r + _ROWS_PER_BLOCK] = _band_sum(dots[r:r + _ROWS_PER_BLOCK], l_st, l_en, w)
        cols.append(np.sqrt(lam) * band)
    return np.hstack(cols)


def cubature_pairing(jmax: int, b: float = 2.0):
    """(pair, use): antipodal partner index of each cubature point and the
    deduplicated index set (spneedlet_pair, sphere_needlets.py:107-128)."""
    pix = np.vstack(cubature_points(jmax, b))  # (K, 3)
    corr = pix @ pix.T
    pair = []
    use = []
    for i in range(pix.shape[0]):
        partner = int(np.where(corr[i] + 1 < 1e-10)[0][0])
        pair.append(partner)
        if partner > i:
            use.append(i)
    return pair, use


def sh_to_needlet_matrix(lmax: int, b: float = 2.0, symmetrized: bool = True) -> np.ndarray:
    """C matrix: symmetrized-SH basis (even l only) -> needlet coefficients.

    The needlet transform of a pure harmonic Φ_lm is
    β_jk = sqrt(λ_j) b(l/B^j) Φ_lm(ξ_jk), so each row is a windowed evaluation
    of the basis function at the cubature points (Ctran_asymm semantics,
    sphere_needlets.py:254-277); `symmetrized` folds antipodal pairs with the
    x2 coefficient rule (Ctran, :281-297).
    """
    jmax = math.ceil(math.log(lmax, b))
    rows = []
    for l in range(0, lmax + 1, 2):
        for m in range(-l, l + 1):
            beta = [np.array([1.0 if (l == 0 and m == 0) else 0.0])]
            for j in range(jmax + 1):
                ns = band_nside(j, b)
                theta, phi = _cubature_angles(ns)
                lam = 4.0 * np.pi / nside2npix(ns)
                wl = needlet_window(l / 2.0 ** j, 2.0) if l >= 1 else 0.0
                if wl == 0.0 or not (
                    int(np.ceil(b ** (j - 1))) <= l <= int(min(np.floor(b ** (j + 1)), lmax))
                ):
                    beta.append(np.zeros(nside2npix(ns)))
                    continue
                basis = symmetrized_sh_matrix(theta, phi, l)[:, l * l + l + m]
                beta.append(np.sqrt(lam) * wl * basis)
            rows.append(np.concatenate(beta))
    C = np.vstack(rows)
    if symmetrized:
        pair, use = cubature_pairing(jmax, b)
        sn = C[:, 1:]
        sn = (sn + sn[:, pair])[:, use]
        C = np.hstack((C[:, :1], sn))
    return C


def _cubature_angles(nside: int):
    from .healpix import pix2ang

    return pix2ang(nside, np.arange(nside2npix(nside)))


def spherical_sampling(jmax: int = 2, b: float = 2.0, n_samples: int = 64,
                       k: int = 3) -> np.ndarray:
    """k nearest top-band cubature pixel ids per golden-spiral sample point.

    Vectorized equivalent of Needlets/utils.py:205-227 (which loops a
    per-point O(Npix) distance scan): Nside = 2^ceil(log2(floor(B^(jmax+1))/2)),
    returns (n_samples, k) int ids into the HEALPix RING pixelization.
    """
    from ..core.geometry import sphere_points

    nside = 2 ** math.ceil(math.log2(math.floor(b ** (jmax + 1)) / 2))
    dirs = pix2vec(nside, np.arange(nside2npix(nside)))  # (Npix, 3)
    pts = sphere_points(n_samples)  # (n_samples, 3)
    d2 = ((pts[:, None, :] - dirs[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1)[:, :k].astype(np.int64)
