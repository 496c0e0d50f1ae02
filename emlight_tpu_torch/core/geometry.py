"""Sphere / equirectangular geometry — own copy of what the port needs.

Same functions and caches as emlight_tpu/core/geometry.py:38-51, 53-245
(that module is JAX-free, but the port imports nothing of the JAX package).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["sphere_points", "geometric_points", "equirect_xyz_splat", "equirect_xyz_gt",
           "steradian_map", "solid_angle_map", "rgb_to_intensity", "polar_to_cartesian",
           "cartesian_to_polar", "nearest_anchor_index", "icosphere", "INTENSITY_WEIGHTS_GT"]

# Luma weights used by GT extraction / light-mask construction
# (distribution_representation.py:16-17,93; GenProjector/data.py:75).
INTENSITY_WEIGHTS_GT = (0.3, 0.59, 0.11)


def rgb_to_intensity(rgb, weights=INTENSITY_WEIGHTS_GT):
    """Luma of an (..., 3) RGB array (NumPy or torch)."""
    wr, wg, wb = weights
    return wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]


@functools.lru_cache(maxsize=None)
def _sphere_points_cached(n: int) -> np.ndarray:
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    theta = golden_angle * np.arange(n)
    z = np.linspace(1 - 1.0 / n, 1.0 / n - 1, n)
    radius = np.sqrt(1 - z * z)
    points = np.zeros((n, 3))
    points[:, 0] = radius * np.cos(theta)
    points[:, 1] = radius * np.sin(theta)
    points[:, 2] = z
    return points


def sphere_points(n: int = 128) -> np.ndarray:
    """N golden-spiral (Fibonacci) points on the unit sphere, (n, 3) float64.

    Cached per n; returns a copy.
    """
    return _sphere_points_cached(int(n)).copy()


def geometric_points(n: int, anchor_depth) -> np.ndarray:
    """GMLight variant: golden-spiral directions pushed to per-anchor depths,
    (n, 3) float64. Only x and y scale with the depth; z stays on the unit
    profile, as the reference has it (RegressionNetwork/gmloss/utils.py:63-73).
    """
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    theta = golden_angle * np.arange(n)
    z = np.linspace(1 - 1.0 / n, 1.0 / n - 1, n)
    radius = np.asarray(anchor_depth)
    points = np.zeros((n, 3))
    points[:, 0] = radius * np.cos(theta)
    points[:, 1] = radius * np.sin(theta)
    points[:, 2] = z
    return points


def polar_to_cartesian(phi, theta):
    """(phi, theta) -> xyz with theta the polar angle from +z, (..., 3)."""
    x = np.sin(theta) * np.cos(phi)
    y = np.sin(theta) * np.sin(phi)
    z = np.cos(theta)
    return np.stack((x, y, z), axis=-1)


def cartesian_to_polar(xyz):
    """xyz (..., 3) -> (phi, theta)."""
    theta = np.arccos(np.clip(xyz[..., 2], -1.0, 1.0))
    phi = np.arctan2(xyz[..., 1], xyz[..., 0])
    return phi, theta


@functools.lru_cache(maxsize=None)
def _equirect_xyz_splat_cached(h: int, w: int) -> np.ndarray:
    # pixel-center grid: lat = (i+0.5) * pi/h, lon = (j+0.5) * 2*pi/w
    lat = (np.arange(h, dtype=np.float64) + 0.5) * (np.pi / h)
    lon = (np.arange(w, dtype=np.float64) + 0.5) * (2.0 * np.pi / w)
    lat, lon = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(lat) * np.cos(lon)
    y = np.sin(lat) * np.sin(lon)
    z = np.cos(lat)
    return np.stack((x, y, z), axis=-1)  # (h, w, 3)


def equirect_xyz_splat(h: int = 128, w: int = 256) -> np.ndarray:
    """Unit-vector grid used by the Gaussian-splat rasterizer, (h, w, 3)."""
    return _equirect_xyz_splat_cached(int(h), int(w))


def steradian_map(height: int, width: int, multiply: bool = True) -> np.ndarray:
    """sin(theta) row weights, optionally scaled by per-pixel area, (h, w)
    float32."""
    s = np.linspace(0, height, num=height, endpoint=False) + 0.5
    s = np.sin(s / height * np.pi)
    s = np.repeat(s[:, None], width, axis=1)
    if multiply:
        s = s * (((2 * np.pi) / width) * (np.pi / height))
    return s.astype(np.float32)


def solid_angle_map(width: int) -> np.ndarray:
    """Exact per-pixel solid angles for a (width/2, width) panorama, float64.

    Port of Needlets/utils.py:35-50 (cos-difference formula).
    """
    height = width // 2
    y = np.arange(0, height, dtype=np.float64)
    theta = (1.0 - ((y + 0.5) / height)) * np.pi
    pi2_over_w = (np.pi * 2) / width
    pi_over_h = np.pi / height
    sa = pi2_over_w * (np.cos(theta - pi_over_h / 2.0) - np.cos(theta + pi_over_h / 2.0))
    return np.repeat(sa[:, None], width, axis=1)


@functools.lru_cache(maxsize=None)
def _equirect_xyz_gt_cached(h: int, w: int) -> np.ndarray:
    # the GT-extraction grid: endpoint-inclusive linspace over [0, pi] x
    # [0, 2*pi], deliberately not the splat grid
    theta = np.linspace(0.0, np.pi, num=h)
    phi = np.linspace(0.0, 2.0 * np.pi, num=w)
    phi, theta = np.meshgrid(phi, theta)  # (h, w)
    return polar_to_cartesian(phi, theta)  # (h, w, 3)


def equirect_xyz_gt(h: int = 128, w: int = 256) -> np.ndarray:
    """Unit-vector grid used by anchor GT extraction, (h, w, 3)."""
    return _equirect_xyz_gt_cached(int(h), int(w))


@functools.lru_cache(maxsize=None)
def _nearest_anchor_index_cached(h: int, w: int, n: int) -> np.ndarray:
    xyz = equirect_xyz_gt(h, w).reshape(-1, 3)  # (h*w, 3)
    anchors = sphere_points(n)  # (n, 3)
    # argmin of the squared distance; ties resolve to the first minimum, as
    # the reference's argsort does
    d2 = (
        (xyz * xyz).sum(-1)[:, None]
        - 2.0 * xyz @ anchors.T
        + (anchors * anchors).sum(-1)[None, :]
    )
    return d2.argmin(axis=-1).astype(np.int32).reshape(h, w)


def nearest_anchor_index(h: int, w: int, n: int) -> np.ndarray:
    """Per-pixel nearest-anchor index map of the GT grid, (h, w) int32."""
    return _nearest_anchor_index_cached(int(h), int(w), int(n))


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def icosphere(subdivide: int = 1):
    """Loop-subdivided icosahedron projected to the unit sphere: subdivide=1
    gives the 42-vertex mesh of the legacy anchor set, 2 gives 162 vertices.
    Returns (verts (V, 3), faces (F, 3))."""
    verts, faces = _icosahedron()
    for _ in range(int(subdivide)):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            idx = edge_mid.get(key)
            if idx is None:
                m = vlist[a] + vlist[b]
                vlist.append(m / np.linalg.norm(m))
                idx = edge_mid[key] = len(vlist) - 1
            return idx

        for f in faces:
            a, b, c = (int(f[0]), int(f[1]), int(f[2]))
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces
