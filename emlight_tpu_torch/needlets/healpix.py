"""Minimal pure-NumPy HEALPix RING-scheme pixelization.

The reference depends on the healpy C library for three calls —
pix2ang / pix2vec / ringinfo at tiny Nside ∈ {1, 2, 4, 8, 16}
(Needlets/sphere_needlets.py:48-57,111-113) — used only to place needlet
cubature points. This is the standard RING-scheme geometry (Górski et al.
2005) reimplemented in ~60 lines of vectorized NumPy.

The port's own copy of emlight_tpu/needlets/healpix.py, the same arithmetic
bit for bit; ``pix2ang``'s north-cap ring index is copied as it is (the
golden-value tests hold it).
"""

from __future__ import annotations

import numpy as np

__all__ = ["nside2npix", "pix2ang", "pix2vec", "ring_start"]


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def pix2ang(nside: int, ipix) -> tuple[np.ndarray, np.ndarray]:
    """RING-scheme pixel centers -> (theta, phi), vectorized."""
    p = np.asarray(ipix, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    z = np.empty(p.shape, dtype=np.float64)
    phi = np.empty(p.shape, dtype=np.float64)

    # north polar cap: rings i = 1..nside-1 with 4i pixels
    north = p < ncap
    ip = p[north] + 1
    i = (np.sqrt(ip / 2.0 - np.sqrt(ip // 2)).astype(np.int64)) + 1
    j = ip - 2 * i * (i - 1)
    z[north] = 1.0 - (i * i) / (3.0 * nside * nside)
    phi[north] = (j - 0.5) * np.pi / (2.0 * i)

    # equatorial belt: rings i = nside..3*nside with 4*nside pixels
    belt = (p >= ncap) & (p < npix - ncap)
    ip = p[belt] - ncap
    i = ip // (4 * nside) + nside
    j = ip % (4 * nside) + 1
    fodd = 0.5 * (1 + (i + nside) % 2)  # phase shift on alternating rings
    z[belt] = (2.0 * nside - i) * 2.0 / (3.0 * nside)
    phi[belt] = (j - fodd) * np.pi / (2.0 * nside)

    # south polar cap (mirror of the north)
    south = p >= npix - ncap
    ip = npix - p[south]
    i = (np.sqrt(ip / 2.0 - np.sqrt(ip // 2)).astype(np.int64)) + 1
    j = 4 * i + 1 - (ip - 2 * i * (i - 1))
    z[south] = -1.0 + (i * i) / (3.0 * nside * nside)
    phi[south] = (j - 0.5) * np.pi / (2.0 * i)

    return np.arccos(z), phi


def pix2vec(nside: int, ipix) -> np.ndarray:
    """RING-scheme pixel centers as unit vectors, (..., 3)."""
    theta, phi = pix2ang(nside, ipix)
    st = np.sin(theta)
    return np.stack((st * np.cos(phi), st * np.sin(phi), np.cos(theta)), axis=-1)


def ring_start(nside: int) -> np.ndarray:
    """First pixel index of each of the 4*nside-1 rings (ringinfo startpix)."""
    nring = 4 * nside - 1
    starts = np.zeros(nring + 1, dtype=np.int64)
    idx = 0
    for r in range(1, nring + 1):
        starts[r - 1] = idx
        if r < nside:
            idx += 4 * r
        elif r <= 3 * nside:
            idx += 4 * nside
        else:
            idx += 4 * (4 * nside - r)
    starts[nring] = idx
    return starts
