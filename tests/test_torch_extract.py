"""Anchor GT extraction on the port (emlight_tpu_torch.representation.extract,
cli.extract_distribution) and its native batch loader (native.load_batch,
native.tonemap_alpha) against the JAX package's: the extractors at rtol
1e-5, the loader and tonemap bit for bit against emlight_tpu.native on
NONE / ZIP / PIZ x HALF / FLOAT files, down- and upscaled, and the CLIs'
pickles on one directory of panoramas."""

import os
import pickle

import jax
import numpy as np
import pytest

from emlight_tpu import native as jnative
from emlight_tpu.cli import extract_distribution as jcli
from emlight_tpu.core.exr import write_exr as jwrite_exr
from emlight_tpu.representation import extract as J
from emlight_tpu_torch import native as tnative
from emlight_tpu_torch.cli import extract_distribution as tcli
from emlight_tpu_torch.representation import extract as T
from test_torch_io import _hdr_image
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

BAR = dict(rtol=1e-5, atol=1e-7)
# file name -> (H, W, compression, half)
PANOS = {
    "p0": (64, 128, "piz", True),   # the Laval wire format
    "p1": (64, 128, "zip", False),
    "p2": (32, 64, "none", True),   # upscaled to the CLI's 64x128
    "p3": (64, 128, "piz", False),
    "p4": (128, 256, "zip", True),  # downscaled
}


@pytest.fixture(scope="module")
def panos(tmp_path_factory):
    d = tmp_path_factory.mktemp("panos")
    for i, (name, (h, w, comp, half)) in enumerate(PANOS.items()):
        jwrite_exr(str(d / f"{name}.exr"), _hdr_image(h, w, seed=i), half=half,
                   compression=comp)
    return d


def _lit(b, h, w, seed):
    return np.stack([_hdr_image(h, w, seed=seed + i) for i in range(b)])


def _close(got, ref, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), **BAR, err_msg=k)


@pytest.mark.parametrize("n", [96, 128])
def test_extract_anchors_batch_matches_jax(n):
    hdrs = _lit(3, 64, 128, seed=10)
    ref = jax.tree.map(np.asarray, J.extract_anchors_batch(hdrs, n=n))
    got = {k: v.numpy() for k, v in T.extract_anchors_batch(hdrs, n=n, device="cpu").items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    _close(got, ref, ref)
    np.testing.assert_allclose(got["distribution"].sum(-1), 1.0, rtol=1e-5)


def test_extract_anchors_and_extractor_match_jax():
    hdr = _hdr_image(64, 128, seed=3)
    ref = jax.tree.map(np.asarray, J.extract_anchors(hdr, n=128, light_threshold=0.1))
    got = T.extract_anchors(hdr, n=128, light_threshold=0.1, device="cpu")
    _close({k: v.numpy() for k, v in got.items()}, ref, ref)
    jp, jmap = J.AnchorExtractor(64, 128, 96).compute(hdr)
    tp, tmap = T.AnchorExtractor(64, 128, 96, device="cpu").compute(hdr)
    assert set(tp) == set(jp) and tp["intensity"].shape == ()
    _close(tp, jp, jp)
    np.testing.assert_array_equal(tmap, jmap)
    hdrs = _lit(2, 64, 128, seed=20)
    _close(T.AnchorExtractor(ln=96, device="cpu").compute_batch(hdrs),
           J.AnchorExtractor(ln=96).compute_batch(hdrs), ("distribution", "intensity",
                                                         "rgb_ratio", "ambient", "map"))


def test_legacy_extraction_matches_jax():
    """42 icosphere anchors on the unshifted lattice, +1e-9, rgb_ratio
    summing to 1."""
    hdr = _hdr_image(32, 64, seed=5)
    ref = jax.tree.map(np.asarray, J.extract_light_info_legacy(hdr))
    got = {k: v.numpy() for k, v in T.extract_light_info_legacy(hdr, device="cpu").items()}
    assert got["distribution"].shape == (42,)
    _close(got, ref, ref)
    np.testing.assert_allclose(got["rgb_ratio"].sum(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("out_hw", [(64, 128), (32, 64), (100, 200)], ids=["same", "down", "up"])
@pytest.mark.parametrize("tonemap", [None, (2.4, 50.0, 0.5)], ids=["raw", "tonemap"])
def test_load_batch_bit_for_bit(panos, out_hw, tonemap):
    """Every file of PANOS (NONE / ZIP / PIZ x HALF / FLOAT, three sizes)
    in one batch: decoded, area-resized (bilinear-like where it grows) and
    tonemapped exactly as emlight_tpu.native does."""
    paths = [str(panos / f"{n}.exr") for n in PANOS]
    got, ga = tnative.load_batch(paths, out_hw, tonemap=tonemap)
    ref, ra = jnative.load_batch(paths, out_hw, tonemap=tonemap)
    assert got.shape == (len(PANOS), *out_hw, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    if tonemap is None:
        assert ga is None and ra is None
    else:
        np.testing.assert_array_equal(ga, ra)


@pytest.mark.parametrize("apply", [False, True])
def test_tonemap_alpha_bit_for_bit(apply):
    img = _hdr_image(40, 60, seed=7)
    for pct in (50.0, 99.0, 37.3):
        got = tnative.tonemap_alpha(img, 2.4, pct, 0.5, apply=apply)
        ref = jnative.tonemap_alpha(img.copy(), 2.4, pct, 0.5, apply=apply)
        if apply:
            np.testing.assert_array_equal(got[0], ref[0])
            assert got[1] == ref[1]
        else:
            assert got == ref


def test_load_batch_raises_naming_the_file(panos, tmp_path):
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"not an exr file at all")
    with pytest.raises(IOError, match="bad.exr"):
        tnative.load_batch([str(panos / "p0.exr"), str(bad)], (32, 64))


def test_extract_distribution_matches_jax_cli(panos, tmp_path):
    """Both CLIs on one directory (batch 2: a ragged last batch): the same
    pickles (keys, dtypes, shapes; values at rtol 1e-5) and a preview per
    panorama."""
    args = ["--hdr_dir", str(panos), "--anchors", "96", "--height", "64", "--batch", "2"]
    jcli.main(args + ["--out_dir", str(tmp_path / "j")])
    st = tcli.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu",
                           "--preview_dir", str(tmp_path / "prev")])
    assert st["panoramas"] == len(PANOS) and len(st["load_ms"]) == 3 and st["device_ms"] == []
    assert sorted(os.listdir(tmp_path / "t")) == sorted(f"{n}.pickle" for n in PANOS)
    assert sorted(os.listdir(tmp_path / "prev")) == sorted(f"{n}_rec.png" for n in PANOS)
    for n in PANOS:
        with open(tmp_path / "j" / f"{n}.pickle", "rb") as f:
            ref = pickle.load(f)
        with open(tmp_path / "t" / f"{n}.pickle", "rb") as f:
            got = pickle.load(f)
        assert {k: (type(v), v.dtype, v.shape) for k, v in got.items()} == {
            k: (type(v), v.dtype, v.shape) for k, v in ref.items()}
        _close(got, ref, ref)


def test_extract_distribution_raises_on_a_refused_file(panos, tmp_path):
    """The JAX CLI falls back to its Python codec; the port's reader is the
    native codec alone, so a file it refuses raises, named."""
    d = tmp_path / "hdr"
    d.mkdir()
    os.symlink(panos / "p0.exr", d / "a.exr")
    (d / "b.exr").write_bytes(b"\x76\x2f\x31\x01" + b"\0" * 64)
    with pytest.raises(IOError, match="b.exr"):
        tcli.main(["--hdr_dir", str(d), "--out_dir", str(tmp_path / "out"), "--height", "32",
                   "--device", "cpu"])
