"""HDR panorama I/O, tonemapping, and panorama manipulation (host side).

The port's own copy of emlight_tpu/core/hdr.py, with two changes:

- read_hdr / write_hdr route .exr through the port's native codec
  (emlight_tpu_torch/native, built with g++ at first use), as the JAX
  package routes it through its own, but with no fallback: a failed build
  or a file the native decoder refuses raises. The pure-Python codec
  (core/exr.py) stays the oracle and the reader of other channel sets
  (``read_exr(path, channels=...)``). Other formats (.hdr) keep the lazy
  cv2 / imageio import;
- resize_panorama computes OpenCV's INTER_AREA itself, in NumPy, as
  separable per-axis weight matrices (the JAX function calls cv2.resize;
  the port does not depend on OpenCV).

Reference behavior (RegressionNetwork/util.py): TonemapHDR :36-66,
tonemapping presets :187-200, steradian split :118-136, crop from panorama
:146-185, resize / rotate :101-105,138-144.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from .. import native
from .geometry import steradian_map

__all__ = [
    "read_hdr",
    "write_hdr",
    "Tonemap",
    "TONEMAP_INPUT",
    "TONEMAP_VIZ",
    "TONEMAP_TEST",
    "tonemap_alpha",
    "prepare_gt_panorama",
    "resize_panorama",
    "rotate_panorama",
    "crop_panorama",
    "warp_panorama",
]


def read_hdr(path: str) -> np.ndarray:
    """Read an HDR image (.exr via the native codec, else cv2/imageio) as (H,W,3) float32."""
    if path.lower().endswith(".exr"):
        return native.read_exr(path)
    try:
        import cv2

        img = cv2.imread(path, flags=cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"cv2 could not read {path}")
        return np.ascontiguousarray(img[..., ::-1]).astype(np.float32)
    except ImportError:
        import imageio

        return np.asarray(imageio.imread(path), dtype=np.float32)


def write_hdr(path: str, data: np.ndarray) -> None:
    """.exr: an (H, W, 3) image through the native writer (ZIP, FLOAT);
    else imageio."""
    if path.lower().endswith(".exr"):
        native.write_exr(path, data)
    else:
        import imageio

        imageio.imwrite(path, data.astype(np.float32))


@dataclass(frozen=True)
class Tonemap:
    """Global percentile tonemap: alpha maps percentile(I^(1/gamma)) -> max_mapping.

    Exact port of TonemapHDR (RegressionNetwork/util.py:36-66). The returned
    alpha is load-bearing: the datasets reuse it to rescale GT intensity /
    ambient / env maps (RegressionNetwork/data.py:71-73, GenProjector/data.py:69-102).
    """

    gamma: float = 2.4
    percentile: float = 50.0
    max_mapping: float = 0.5

    def __call__(self, img, clip: bool = True, alpha: float | None = None, gamma: bool = True):
        img = np.asarray(img)
        powered = np.power(img, 1.0 / self.gamma) if gamma else img
        nonzero = powered > 0
        if nonzero.any():
            r_pct = np.percentile(powered[nonzero], self.percentile)
        else:
            r_pct = np.percentile(powered, self.percentile)
        if alpha is None:
            alpha = self.max_mapping / (r_pct + 1e-10)
        out = alpha * powered
        if clip:
            out = np.clip(out, 0, 1)
        return out.astype(np.float32), alpha


# The reference's main presets (catalog in SURVEY.md §2.5):
TONEMAP_INPUT = Tonemap(gamma=2.4, percentile=50, max_mapping=0.5)  # data.py:43
TONEMAP_VIZ = Tonemap(gamma=2.4, percentile=99, max_mapping=0.99)  # train.py:63
TONEMAP_TEST = Tonemap(gamma=2.4, percentile=99, max_mapping=0.9)  # test.py:34
TONEMAP_FREE = Tonemap(gamma=2.4, percentile=99, max_mapping=0.8)  # util.py:187-200


def tonemap_alpha(img: np.ndarray, tm: Tonemap = TONEMAP_INPUT, gamma: bool = True) -> float:
    """Just the alpha scalar of a tonemap (the per-sample GT rescale factor)."""
    _, alpha = tm(img, clip=False, gamma=gamma)
    return float(alpha)


def prepare_gt_panorama(hdr_img: np.ndarray, threshold: float | None = None):
    """Split a panorama into (light-only HDR, ambient RGB) at an intensity threshold.

    Port of PanoramaHandler.prepare_gt_panorama (util.py:118-136), including the
    bugged Rec.709 luma it uses. Does not mutate the input.
    """
    hdr_img = np.array(hdr_img, dtype=np.float32, copy=True)
    weight = steradian_map(hdr_img.shape[0], hdr_img.shape[1])
    intensity = (
        0.2126 * hdr_img[..., 0] + 0.7152 * hdr_img[..., 1] + 0.0722 * hdr_img[..., 0]
    )
    if threshold is None or threshold < 0.0:
        threshold = intensity.max() / 20.0
    mask = intensity < threshold
    if mask.any():
        ambient = (hdr_img[mask] * weight[mask][:, None]).sum(axis=0) / weight[mask].sum()
        ambient = ambient.astype(np.float32)
    else:
        ambient = np.zeros(3, dtype=np.float32)
    hdr_img[mask] = 0.0
    return hdr_img, ambient


@functools.lru_cache(maxsize=64)
def _axis_weights(n_in: int, n_out: int, coverage: bool) -> np.ndarray:
    """(n_out, n_in) float32 weights of OpenCV's INTER_AREA along one axis.

    coverage: the area rule, which cv2 takes when neither axis grows
    (computeResizeAreaTab: each output cell averages the input pixels it
    covers, edge pixels by their covered fraction). Otherwise cv2 takes its
    linear resize with INTER_AREA's coefficients on both axes: source
    sx = floor(d * scale), fraction f = (d + 1) - (sx + 1) / scale kept only
    when positive, interpolating between sx and sx + 1, clamped at the edge.
    Integer ratios give the block averages of cv2's fast area path.
    """
    inv = n_out / n_in
    scale = 1.0 / inv
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        if coverage:
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, n_in - f1)
            s2 = min(math.floor(f2), n_in - 1)
            s1 = min(math.ceil(f1), s2)
            if s1 - f1 > 1e-3:
                w[d, s1 - 1] += np.float32((s1 - f1) / cell)
            w[d, s1:s2] += np.float32(1.0 / cell)
            if f2 - s2 > 1e-3:
                w[d, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
        else:
            s = math.floor(d * scale)
            f = np.float32((d + 1) - (s + 1) * inv)
            f = np.float32(0.0) if f <= 0 else f - np.float32(math.floor(f))
            if s >= n_in - 1:
                s, f = n_in - 1, np.float32(0.0)
            w[d, s] += np.float32(1.0) - f
            if f:
                w[d, s + 1] += f
    w.flags.writeable = False
    return w


def resize_panorama(img: np.ndarray, new_shape) -> np.ndarray:
    """Area resize, as cv2.resize(img, (w, h), interpolation=INTER_AREA);
    (w, h) tuple or int height (-> 2h x h). util.py:138-144.

    Computed in float64 from cv2's float32 weights and rounded once to the
    input's dtype: cv2 sums in float32 in its own order, so the two agree to
    a few float32 ulps. A (H, W, 1) image comes back (h, w), as from cv2.
    """
    if isinstance(new_shape, int):
        new_shape = (2 * new_shape, new_shape)
    out_w, out_h = (int(v) for v in new_shape)
    h, w = img.shape[:2]
    coverage = out_h <= h and out_w <= w
    wy = _axis_weights(h, out_h, coverage)
    wx = _axis_weights(w, out_w, coverage)
    x = np.asarray(img, np.float64)
    flat = x.reshape(h, w, -1)
    out = np.matmul(wx, np.tensordot(wy, flat, axes=(1, 0)))  # (out_h, out_w, C)
    if img.ndim == 2 or img.shape[2] == 1:
        out = out[..., 0]
    return out.astype(img.dtype)


def rotate_panorama(img: np.ndarray, deg: float) -> np.ndarray:
    """Horizontal (azimuthal) roll of an equirect panorama. util.py:101-105."""
    shift = int(deg / 360.0 * img.shape[1])
    return np.roll(img, shift=shift, axis=1)


def warp_panorama(
    img: np.ndarray,
    res_h: int = 512,
    res_w: int = 512,
    theta_deg: float = 0.0,
    phi_deg: float = 0.0,
    move: float = 0.0,
) -> np.ndarray:
    """Re-render a panorama from a rotated / translated viewpoint.

    Capability of GenProjector/util.py:279-343 (`resize_exr`): build the
    output equirect ray grid, rotate by theta (about x) then phi (about the
    rotated y-axis), translate the view center by `move` along the rotated
    forward direction, renormalize, and resample the source panorama with
    horizontally-wrapping bilinear interpolation. theta=phi=move=0 is a pure
    equirect resample.
    """
    img = np.asarray(img, dtype=np.float32)
    src_h, src_w = img.shape[:2]
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)

    ct, st = np.cos(theta), np.sin(theta)
    rot_theta = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], dtype=np.float64)
    axis = np.array([0.0, np.cos(theta), np.sin(theta)])
    cp, sp = np.cos(phi), -np.sin(phi)
    ax, ay, az = axis
    rot_phi = np.array(
        [
            [cp + ax * ax * (1 - cp), ax * ay * (1 - cp) - az * sp, ax * az * (1 - cp) + ay * sp],
            [ay * ax * (1 - cp) + az * sp, cp + ay * ay * (1 - cp), ay * az * (1 - cp) - ax * sp],
            [az * ax * (1 - cp) - ay * sp, az * ay * (1 - cp) + ax * sp, cp + az * az * (1 - cp)],
        ]
    )

    ix = np.arange(res_h, dtype=np.float64)[:, None].repeat(res_w, 1)
    iy = np.arange(res_w, dtype=np.float64)[None, :].repeat(res_h, 0)
    lat = ix * np.pi / res_h - np.pi / 2
    lon = iy * 2 * np.pi / res_w
    rays = np.stack(
        [np.sin(lat), np.sin(lon) * np.cos(lat), -np.cos(lon) * np.cos(lat)], axis=0
    ).reshape(3, -1)

    move_dir = rot_phi @ (rot_theta @ np.array([0.0, 0.0, -1.0]))
    rays = rot_phi @ (rot_theta @ rays)
    rays = rays + move * move_dir[:, None]
    rays = rays / np.linalg.norm(rays, axis=0, keepdims=True)

    cur_lat = np.arcsin(np.clip(rays[0], -1, 1))
    cur_lon = np.arctan2(rays[1], -rays[2]) % (2 * np.pi)
    sx = (cur_lat + np.pi / 2) / np.pi * src_h
    sy = cur_lon / (2 * np.pi) * src_w

    # wrapping bilinear resample (cv2.BORDER_WRAP semantics)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    x0c = np.clip(x0, 0, src_h - 1)
    x1c = np.clip(x0 + 1, 0, src_h - 1)
    y0w = y0 % src_w
    y1w = (y0 + 1) % src_w
    flat = img.reshape(-1, img.shape[-1] if img.ndim == 3 else 1)
    at = lambda r, c: flat[r * src_w + c]
    out = (
        at(x0c, y0w) * (1 - fx) * (1 - fy)
        + at(x0c, y1w) * (1 - fx) * fy
        + at(x1c, y0w) * fx * (1 - fy)
        + at(x1c, y1w) * fx * fy
    )
    return out.reshape(res_h, res_w, -1).astype(np.float32).squeeze()


def crop_panorama(
    img: np.ndarray,
    fov_deg: float,
    crop_image_h: int = 720,
    aspect_ratio: str = "4:3",
) -> np.ndarray:
    """Perspective (gnomonic) crop from an equirect panorama. util.py:146-185.

    Vectorized bilinear interpolation replaces scipy's RegularGridInterpolator
    (identical math: regular-grid linear interpolation with clamped edges).
    """
    if img.dtype == np.uint8:
        img = img / 255.0
    num, den = (int(x) for x in aspect_ratio.split(":"))
    ratio = num / den
    crop_w = int(crop_image_h * ratio)

    scl = np.tan(np.deg2rad(fov_deg) / 2)
    sx, sy = np.meshgrid(
        np.linspace(-scl, scl, crop_w), np.linspace(-scl / ratio, scl / ratio, crop_image_h)
    )
    r = np.sqrt(sy * sy + sx * sx + 1)
    sx, sy = sx / r, sy / r
    sz = np.sqrt(1 - sy * sy - sx * sx)
    azimuth = np.arctan2(sx, sz)
    elevation = np.arcsin(sy)
    x = (1 + azimuth / np.pi) / 2 * img.shape[1]
    y = (1 + elevation / (np.pi / 2)) / 2 * img.shape[0]

    h, w = img.shape[:2]
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    img2 = img.reshape(h, w, -1)
    out = (
        img2[y0, x0] * (1 - wy) * (1 - wx)
        + img2[y0, x1] * (1 - wy) * wx
        + img2[y1, x0] * wy * (1 - wx)
        + img2[y1, x1] * wy * wx
    )
    return out.reshape(crop_image_h, crop_w, -1)
