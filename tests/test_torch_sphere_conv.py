"""Port of the sphere conv (emlight_tpu_torch.nn.sphere_conv*) against the JAX
package: tables exactly, the plain version at the 1e-5 bar of
tests/test_sphere_conv_pallas.py:28 against both the XLA gather and the
Pallas kernel in interpret mode, and the CUDA kernel against the plain
version on the card (tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.core import geometry as jgeo
from emlight_tpu.nn import sphere_conv as jsc
from emlight_tpu.nn import sphere_conv_pallas as jpal
from emlight_tpu_torch.core import geometry as tgeo
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker

SPADE_RES = [(4, 8), (8, 16), (16, 32), (32, 64), (64, 128), (128, 256)]


@pytest.mark.parametrize("h,w", SPADE_RES)
def test_tables_equal_jax(h, w):
    j_idx, j_wgt, j_hw = jsc.sphere_taps(h, w, 1)
    t_idx, t_wgt, t_hw = tsc.sphere_taps(h, w, 1)
    assert t_hw == j_hw
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_wgt, j_wgt)
    for t_a, j_a in zip(tker.structured_tables(h, w, 1), jpal.structured_tables(h, w, 1)):
        assert t_a.dtype == j_a.dtype
        np.testing.assert_array_equal(t_a, j_a)
    for t_a, j_a in zip(tker.scalar_weight_tables(h, w, 1),
                        jpal.scalar_weight_tables(h, w, 1)):
        assert t_a.dtype == j_a.dtype
        np.testing.assert_array_equal(t_a, j_a)


def test_geometry_equal_jax():
    np.testing.assert_array_equal(tgeo.sphere_points(96), jgeo.sphere_points(96))
    np.testing.assert_array_equal(tgeo.equirect_xyz_splat(128, 256),
                                  jgeo.equirect_xyz_splat(128, 256))


def _inputs(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.random(shape, dtype=np.float32)
    k = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    return x, k, bias


# the stride-1 shapes of tests/test_sphere_conv_pallas.py:11-18, plus cout=3
@pytest.mark.parametrize("shape,cout", [
    ((2, 16, 32, 8), 8),
    ((1, 32, 64, 16), 8),
    ((2, 8, 16, 128), 8),
    ((1, 16, 32, 3), 8),
    ((2, 16, 32, 64), 3),
])
def test_plain_matches_gather_and_pallas(shape, cout):
    x, k, bias = _inputs(shape, cout)
    out = tsc.sphere_conv_plain(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(bias)).numpy()
    ref = np.asarray(jsc.sphere_conv_gather(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    pal = np.asarray(jpal.sphere_conv_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                             1, block_rows=8, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pal, rtol=1e-5, atol=1e-5)


def test_plain_stride2_matches_gather():
    x, k, bias = _inputs((2, 16, 32, 8), 8)
    out = tsc.sphere_conv_plain(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(bias), stride=2).numpy()
    ref = np.asarray(jsc.sphere_conv_gather(jnp.asarray(x), jnp.asarray(k),
                                            jnp.asarray(bias), 2))
    assert out.shape == (2, 8, 16, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_plain_bf16_tracks_f32():
    """bf16 inputs: read in bf16, staged operand rounded once to bf16, f32
    accumulation — within bf16 resolution of the f32 result."""
    x, k, bias = _inputs((2, 16, 32, 64), 32, seed=4)
    xt, kt, bt = torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias)
    ref = tsc.sphere_conv_plain(xt, kt, bt)
    out = tsc.sphere_conv_plain(xt.bfloat16(), kt.bfloat16(), bt)
    assert out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


def test_cpu_dispatch_takes_plain_version():
    x, k, bias = _inputs((1, 8, 16, 8), 16, seed=2)
    xt, kt, bt = torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias)
    before = tker.sphere_conv_s1.launches
    out = tsc.sphere_conv(xt, kt, bt, 1)
    assert tker.sphere_conv_s1.launches == before  # no kernel launched on the CPU
    torch.testing.assert_close(out, tsc.sphere_conv_plain(xt, kt, bt), rtol=0, atol=0)
    out2 = tsc.sphere_conv(xt, kt, bt, 2)
    torch.testing.assert_close(out2, tsc.sphere_conv_plain(xt, kt, bt, 2), rtol=0, atol=0)


def test_sphere_conv2d_init_bound():
    gen = torch.Generator().manual_seed(0)
    conv = tsc.SphereConv2D(16, 32, generator=gen)
    bound = np.sqrt(6.0 / (6 * 9 * 16))
    assert conv.kernel.shape == (3, 3, 16, 32)
    assert conv.kernel.abs().max().item() <= bound
    assert conv.kernel.abs().max().item() > 0.9 * bound
    assert (conv.bias == 0).all()
