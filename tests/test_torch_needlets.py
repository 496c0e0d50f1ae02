"""The port's needlets (emlight_tpu_torch/needlets/) against the JAX
package's, on the CPU.

The NumPy float64 parts are held bit for bit (np.array_equal): the
harmonics, HEALPix, the window, the band layout, the cubature pairing, the
SH -> needlet matrix and the needlet basis matrix (jmax 2 on a 32x64 grid,
jmax 3 on a 16x32 grid, so the streamed Legendre recurrence runs to lmax
16, and again with blocks of a few grid rows). The pipeline's float32
products at rtol 1e-5 of the largest value, and sparsify fed the JAX
package's own coefficients exactly, at tests/test_needlets.py's 32x64
config."""

import dataclasses
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu import config as jcfg
from emlight_tpu.core import geometry as jgeo
from emlight_tpu.needlets import NeedletPipeline as JaxPipeline
from emlight_tpu.needlets import harmonics as JH
from emlight_tpu.needlets import healpix as JP
from emlight_tpu.needlets import needlets as JN
from emlight_tpu.needlets.pipeline import gt_grid_angles as jax_grid_angles
from emlight_tpu_torch import config as tcfg
from emlight_tpu_torch.core import geometry as tgeo
from emlight_tpu_torch.needlets import NeedletPipeline, gt_grid_angles
from emlight_tpu_torch.needlets import harmonics as TH
from emlight_tpu_torch.needlets import healpix as TP
from emlight_tpu_torch.needlets import needlets as TN
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

THETA = np.array([0.0, 0.3, 1.2, 2.0, np.pi / 2, np.pi])
PHI = np.array([0.5, 2.5, 4.0, 0.0, 6.1, 3.3])


def _same(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    assert np.array_equal(a, b)


def test_harmonics_bit_for_bit():
    x = np.cos(THETA)
    _same(TH.legendre_all(8, x), JH.legendre_all(8, x))
    _same(TH.legendre_poly(16, x), JH.legendre_poly(16, x))
    _same(TH.real_sh_matrix(THETA, PHI, 5), JH.real_sh_matrix(THETA, PHI, 5))
    _same(TH.symmetrized_sh_matrix(THETA, PHI, 4), JH.symmetrized_sh_matrix(THETA, PHI, 4))
    for l, m in [(0, 0), (1, 1), (3, -2), (4, 4)]:
        _same(TH.real_sh(l, m, THETA, PHI), JH.real_sh(l, m, THETA, PHI))
        _same(TH.complex_sh(l, m, THETA, PHI), JH.complex_sh(l, m, THETA, PHI))
    assert (TH.sh_index(3, -2), TH.sh_terms(4)) == (JH.sh_index(3, -2), JH.sh_terms(4))


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16])
def test_healpix_bit_for_bit(nside):
    pix = np.arange(TP.nside2npix(nside))
    assert TP.nside2npix(nside) == JP.nside2npix(nside)
    for a, b in zip(TP.pix2ang(nside, pix), JP.pix2ang(nside, pix)):
        _same(a, b)
    _same(TP.pix2vec(nside, pix), JP.pix2vec(nside, pix))
    _same(TP.ring_start(nside), JP.ring_start(nside))


def test_healpix_golden_values_nside1():
    """tests/test_needlets.py's golden values on the port's copy (the
    north-cap index formula as the JAX package has it)."""
    theta, phi = TP.pix2ang(1, np.arange(12))
    z = np.cos(theta)
    np.testing.assert_allclose(z[:4], 2 / 3, rtol=1e-12)
    np.testing.assert_allclose(z[4:8], 0, atol=1e-12)
    np.testing.assert_allclose(z[8:], -2 / 3, rtol=1e-12)
    np.testing.assert_allclose(phi[:4], [np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4])


def test_window_bands_and_pairing_bit_for_bit():
    for x in np.linspace(0, 5, 41):
        _same(np.float64(TN.needlet_window(x)), np.float64(JN.needlet_window(x)))
    for jmax in (2, 3):
        assert [TN.band_nside(j) for j in range(jmax + 1)] == [
            JN.band_nside(j) for j in range(jmax + 1)]
        assert TN.band_slices(jmax) == JN.band_slices(jmax)
        for a, b in zip(TN.cubature_points(jmax), JN.cubature_points(jmax)):
            _same(a, b)
        assert TN.cubature_pairing(jmax) == JN.cubature_pairing(jmax)
    for sym in (True, False):
        _same(TN.sh_to_needlet_matrix(4, symmetrized=sym),
              JN.sh_to_needlet_matrix(4, symmetrized=sym))
    _same(TN.spherical_sampling(2), JN.spherical_sampling(2))
    _same(tgeo.solid_angle_map(64), jgeo.solid_angle_map(64))
    assert dataclasses.asdict(tcfg.NeedletsConfig()) == dataclasses.asdict(jcfg.NeedletsConfig())


@pytest.mark.parametrize("rows", [None, 100])
@pytest.mark.parametrize("jmax,hw", [(2, (32, 64)), (3, (16, 32))])
def test_basis_matrix_bit_for_bit(monkeypatch, jmax, hw, rows):
    """The streamed recurrence, in one block and in blocks of 100 grid rows
    (a ragged last one), gives the JAX package's materialised sum's bits."""
    if rows:
        monkeypatch.setattr(TN, "_ROWS_PER_BLOCK", rows)
    theta, phi = gt_grid_angles(*hw)
    for a, b in zip((theta, phi), jax_grid_angles(*hw)):
        _same(a, b)
    _same(TN.needlet_basis_matrix(theta, phi, jmax), JN.needlet_basis_matrix(theta, phi, jmax))


def test_basis_matrix_holds_no_legendre_stack():
    """At jmax 3 on 16x32 the JAX package's (lmax+1, N, K) float64 stack of
    the top band is 17 x 512 x 768 x 8 bytes; the port's build peaks well
    under half of it (numpy reports its buffers to tracemalloc)."""
    theta, phi = gt_grid_angles(16, 32)
    stack = 17 * 512 * 768 * 8
    tracemalloc.start()
    try:
        TN.needlet_basis_matrix(theta, phi, 3)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < stack / 2, (peak, stack)


@pytest.fixture(scope="module")
def pipelines():
    jc = dataclasses.replace(jcfg.NeedletsConfig(), env_h=32, env_w=64, jmax=2)
    tc = dataclasses.replace(tcfg.NeedletsConfig(), env_h=32, env_w=64, jmax=2)
    rng = np.random.default_rng(3)
    theta, phi = np.meshgrid(np.linspace(0, np.pi, 32), np.linspace(0, 2 * np.pi, 64),
                             indexing="ij")
    img = (1.0 + 0.5 * np.cos(theta) + 0.3 * np.sin(theta) * np.cos(phi)).astype(np.float32)
    imgs = np.stack([np.stack([img, 0.8 * img, 0.6 * img], -1),
                     rng.random((32, 64, 3)).astype(np.float32) * 2.0])
    return JaxPipeline(jc), NeedletPipeline(tc, device="cpu"), imgs


def _close(got, ref, rtol=1e-5):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_pipeline_matches_jax(pipelines):
    jp, tp, imgs = pipelines
    _same(tp.sn.numpy(), np.asarray(jp.sn))
    _same(tp.solid.numpy(), np.asarray(jp.solid))
    assert tp.slices == jp.slices and tp.n_coeffs == jp.n_coeffs == 253
    ref = np.array(jp.project(jnp.asarray(imgs)))
    got = tp.project(torch.from_numpy(imgs))
    _close(got.numpy(), ref)
    _close(tp.reconstruct(torch.from_numpy(ref)).numpy(),
           np.asarray(jp.reconstruct(jnp.asarray(ref))))


def test_sparsify_matches_jax_exactly(pipelines):
    """Fed the JAX package's own coefficients, the port keeps and zeroes the
    same ones: torch.quantile's linear interpolation is jnp.percentile's."""
    jp, tp, imgs = pipelines
    coeffs = np.array(jp.project(jnp.asarray(imgs)))
    ref = np.asarray(jp.sparsify(jnp.asarray(coeffs)))
    got = tp.sparsify(torch.from_numpy(coeffs)).numpy()
    _same(got, ref)
    for sl, keep in zip(tp.slices, (0.70, 0.55, 0.25)):  # tests/test_needlets.py's fractions
        frac = (np.abs(got[:, sl]).sum(-1) > 0).mean()
        assert abs(frac - keep) < 0.15, (sl, frac, keep)
