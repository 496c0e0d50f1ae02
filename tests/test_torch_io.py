"""The port's host-side image I/O (emlight_tpu_torch.core: exr, piz, hdr,
png) against the JAX package's (emlight_tpu.core) and against cv2 / PIL,
on seeded NumPy images."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from emlight_tpu.core import exr as jexr
from emlight_tpu.core import hdr as jhdr
from emlight_tpu.core import piz as jpiz
from emlight_tpu_torch.core import exr as texr
from emlight_tpu_torch.core import hdr as thdr
from emlight_tpu_torch.core import piz as tpiz
from emlight_tpu_torch.core.png import encode_png, write_png
from torch_port_helpers import one_torch_thread  # noqa: F401

COMPRESSIONS = ("none", "zip", "zips", "piz")


def _hdr_image(h, w, c=3, seed=0):
    """An HDR-range image: a smooth dim background with a little noise and a
    few bright light spots, on a grid of 1/1024 (so that ZIP and PIZ
    compress it, in FLOAT too, as they do photographs)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.15 + 0.1 * np.sin(6 * x + 2 * y)[..., None] * np.linspace(1.0, 0.6, c)
    img = (img + rng.normal(0, 0.01, (h, w, c))).astype(np.float32)
    for _ in range(3):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 6)
        img[y:y + 4, x:x + 6] = rng.uniform(20, 60, c)
    return np.round(img * 1024) / np.float32(1024)


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_read_exr_matches_jax(tmp_path, monkeypatch, compression, half):
    """Files the JAX codec writes decode bit for bit the same; 45 rows end
    on a partial chunk for ZIP (16 lines) and PIZ (32). Every chunk of a
    compressed file goes through its decoder (none is stored raw)."""
    img = _hdr_image(45, 96, seed=1)
    path = str(tmp_path / "a.exr")
    jexr.write_exr(path, img, half=half, compression=compression)
    ref = jexr.read_exr(path)
    decoded = []
    for mod, name in ((texr, "_zip_decode"), (tpiz, "decode_chunk")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real: decoded.append(1) or real(*a))
    out = texr.read_exr(path)
    n_chunks = {"none": 0, "zips": 45, "zip": 3, "piz": 2}[compression]
    assert len(decoded) == n_chunks
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    expect = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("compression", ["zip", "piz"])
def test_read_exr_channel_subset(tmp_path, compression):
    img = _hdr_image(20, 24, c=4, seed=2)
    path = str(tmp_path / "rgba.exr")
    jexr.write_exr(path, img, channels="RGBA", compression=compression)
    np.testing.assert_array_equal(texr.read_exr(path), jexr.read_exr(path))
    np.testing.assert_array_equal(texr.read_exr(path), img[..., :3])
    np.testing.assert_array_equal(texr.read_exr(path, channels="AR"), img[..., [3, 0]])
    with pytest.raises(texr.EXRError, match="not in file"):
        texr.read_exr(path, channels="RZ")


def test_read_exr_bad_magic(tmp_path):
    path = tmp_path / "bad.exr"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(texr.EXRError, match="bad EXR magic"):
        texr.read_exr(str(path))
    path.write_bytes(b"\x76")
    with pytest.raises(texr.EXRError, match="truncated"):
        texr.read_exr(str(path))


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_write_exr_matches_jax(tmp_path, compression, half):
    """The port writes the JAX codec's bytes, which JAX reads back equal."""
    img = _hdr_image(37, 50, seed=3)
    ours, theirs = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    texr.write_exr(ours, img, half=half, compression=compression)
    jexr.write_exr(theirs, img, half=half, compression=compression)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(jexr.read_exr(ours), texr.read_exr(ours))


@pytest.mark.parametrize("units", [[1, 1, 1], [2, 2, 2], [1, 2]], ids=["half", "float", "mixed"])
def test_piz_chunks_match_jax(units):
    """encode_chunk and decode_chunk of both packages, byte for byte, on a
    32-line chunk of HDR-range values."""
    width, n_lines = 29, 32
    rng = np.random.default_rng(4)
    rows = []
    for _ in range(n_lines):
        for u in units:
            dt = np.float16 if u == 1 else np.float32
            rows.append((rng.random(width) * rng.choice([0.2, 50.0], width)).astype(dt).tobytes())
    raw = b"".join(rows)
    enc = tpiz.encode_chunk(raw, units, width, n_lines)
    assert enc == jpiz.encode_chunk(raw, units, width, n_lines)
    dec = tpiz.decode_chunk(enc, units, width, n_lines)
    assert dec == jpiz.decode_chunk(enc, units, width, n_lines) == raw


@pytest.mark.parametrize("tm", ["TONEMAP_INPUT", "TONEMAP_VIZ", "TONEMAP_TEST", "TONEMAP_FREE"])
def test_tonemap_presets_match_jax(tm):
    img = _hdr_image(32, 48, seed=5)
    out, alpha = getattr(thdr, tm)(img)
    ref, ref_alpha = getattr(jhdr, tm)(img)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(alpha, ref_alpha, rtol=1e-6)
    custom = thdr.Tonemap(gamma=2.2, percentile=90, max_mapping=0.7)
    ref_custom = jhdr.Tonemap(gamma=2.2, percentile=90, max_mapping=0.7)
    for kw in ({"clip": False}, {"alpha": 0.3}, {"gamma": False}):
        np.testing.assert_allclose(custom(img, **kw)[0], ref_custom(img, **kw)[0], rtol=1e-6)
    assert thdr.tonemap_alpha(img) == pytest.approx(jhdr.tonemap_alpha(img), rel=1e-6)
    zero = np.zeros((4, 4, 3), np.float32)  # no nonzero pixel: the plain percentile
    np.testing.assert_array_equal(thdr.TONEMAP_INPUT(zero)[0], jhdr.TONEMAP_INPUT(zero)[0])


@pytest.mark.parametrize("threshold", [None, 5.0, 1e9])
def test_prepare_gt_panorama_matches_jax(threshold):
    pano = _hdr_image(32, 64, seed=6)
    light, amb = thdr.prepare_gt_panorama(pano, threshold)
    ref_light, ref_amb = jhdr.prepare_gt_panorama(pano, threshold)
    np.testing.assert_allclose(light, ref_light, rtol=1e-6)
    np.testing.assert_allclose(amb, ref_amb, rtol=1e-6)


def test_panorama_warps_match_jax():
    pano = _hdr_image(32, 64, seed=7)
    for deg in (0.0, 45.0, -100.0):
        np.testing.assert_array_equal(thdr.rotate_panorama(pano, deg),
                                      jhdr.rotate_panorama(pano, deg))
    for kw in ({}, {"theta_deg": 20.0, "phi_deg": -35.0, "move": 0.3}):
        np.testing.assert_allclose(thdr.warp_panorama(pano, 24, 48, **kw),
                                   jhdr.warp_panorama(pano, 24, 48, **kw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(thdr.crop_panorama(pano, 60.0, 18, "4:3"),
                               jhdr.crop_panorama(pano, 60.0, 18, "4:3"), rtol=1e-6, atol=1e-7)
    u8 = (pano * 4).clip(0, 255).astype(np.uint8)
    np.testing.assert_allclose(thdr.crop_panorama(u8, 90.0, 12, "16:9"),
                               jhdr.crop_panorama(u8, 90.0, 12, "16:9"), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("src,dst", [
    ((192, 256), (128, 128)),   # the CLI's encoder input: x1.5 and x2
    ((384, 512), (192, 256)),   # the CLI's regressor-side resize: x2 (cv2's fast path)
    ((100, 150), (48, 64)),     # fractional on both axes
    ((24, 40), (64, 100)),      # upscale
    ((40, 100), (60, 50)),      # mixed: H grows, W shrinks
    ((90, 30), (45, 80)),       # mixed: H shrinks, W grows
])
def test_resize_panorama_matches_cv2_inter_area(src, dst):
    img = _hdr_image(*src, seed=8)
    out = thdr.resize_panorama(img, (dst[1], dst[0]))
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_resize_panorama_int_height_and_one_channel():
    img = _hdr_image(64, 128, seed=9)
    np.testing.assert_allclose(thdr.resize_panorama(img, 16),
                               cv2.resize(img, (32, 16), interpolation=cv2.INTER_AREA),
                               rtol=1e-5, atol=1e-6)
    one = img[..., :1]
    ref = cv2.resize(one, (48, 20), interpolation=cv2.INTER_AREA)
    assert ref.ndim == 2
    np.testing.assert_allclose(thdr.resize_panorama(one, (48, 20)), ref, rtol=1e-5, atol=1e-6)


def test_read_write_hdr_exr_round_trip(tmp_path):
    img = _hdr_image(16, 20, seed=10)
    path = str(tmp_path / "p.exr")
    thdr.write_hdr(path, img)
    np.testing.assert_array_equal(thdr.read_hdr(path), img)
    np.testing.assert_array_equal(jhdr.read_hdr(path), img)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 128)])
def test_png_writer_decodes_with_pil(tmp_path, shape):
    rgb = np.random.default_rng(11).integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, rgb)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), rgb)
    with Image.open(io.BytesIO(encode_png(rgb))) as im:
        np.testing.assert_array_equal(np.asarray(im), rgb)


def test_png_writer_rejects_other_arrays():
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("hw", [(32, 64), (9, 14)])
def test_geometry_helpers_match_jax(hw):
    """The helpers hdr.prepare_gt_panorama's module imports: steradian_map
    (both modes) and rgb_to_intensity at the GT weights."""
    from emlight_tpu.core import geometry as jgeo
    from emlight_tpu_torch.core import geometry as tgeo

    for multiply in (True, False):
        out, ref = tgeo.steradian_map(*hw, multiply=multiply), jgeo.steradian_map(*hw, multiply)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
    rgb = _hdr_image(*hw, seed=12)
    assert tgeo.INTENSITY_WEIGHTS_GT == jgeo.INTENSITY_WEIGHTS_GT
    np.testing.assert_array_equal(tgeo.rgb_to_intensity(rgb), jgeo.rgb_to_intensity(rgb))
