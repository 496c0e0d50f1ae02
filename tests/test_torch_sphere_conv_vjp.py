"""Port of the sphere conv's gradient (emlight_tpu_torch.nn.sphere_conv_vjp)
against the JAX package: the inverse tables exactly, the plain dx and dK
against the Pallas kernels in interpret mode, and SphereConvFunction's
dx/dK/db against jax.grad of sphere_conv_trainable at the rtol = atol = 1e-4
bar of tests/test_sphere_conv_vjp.py:66-69."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import sphere_conv_vjp as jvjp
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from emlight_tpu_torch.nn import sphere_conv_vjp as tvjp

# every map size a sphere conv sees in the generator (4x8 to 128x256) and in
# the discriminator (its stride-2 inputs 16x32 to 128x256)
G_RES = [(4, 8), (8, 16), (16, 32), (32, 64), (64, 128), (128, 256)]
D_S2_RES = [(16, 32), (32, 64), (64, 128), (128, 256)]


@pytest.mark.parametrize("h,w,stride", [(h, w, 1) for h, w in G_RES]
                         + [(h, w, 2) for h, w in D_S2_RES])
def test_inverse_tables_equal_jax(h, w, stride):
    for t_a, j_a in zip(tvjp.inverse_tables(h, w, stride), jvjp.inverse_tables(h, w, stride)):
        if isinstance(j_a, int):
            assert t_a == j_a
        else:
            assert t_a.dtype == j_a.dtype
            np.testing.assert_array_equal(t_a, j_a)


@pytest.mark.parametrize("h,w,stride", [(8, 16, 1), (16, 32, 1), (16, 32, 2), (32, 64, 2)])
def test_inverse_flat_tables_equal_jax(h, w, stride):
    for t_a, j_a in zip(tvjp._inverse_flat_tables(h, w, stride),
                        jvjp._inverse_flat_tables(h, w, stride)):
        np.testing.assert_array_equal(t_a, j_a)


def _grad_inputs(shape, cout, stride, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w, cin = shape
    x = rng.random(shape, dtype=np.float32)
    k = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    g = rng.standard_normal((b, h // stride, w // stride, cout)).astype(np.float32)
    return x, k, g


# small shapes with the ragged widths of the training path: cin 3 (guide),
# cin 6 (guide + env map into D), cout 3 (sphere_conv1, model4_conv)
GRAD_CASES = [((2, 16, 32, 8), 8, 1), ((1, 16, 32, 3), 8, 1), ((2, 16, 32, 16), 3, 1),
              ((2, 16, 32, 6), 8, 2), ((1, 16, 32, 8), 3, 2), ((2, 16, 32, 8), 8, 2)]


@pytest.mark.parametrize("shape,cout,stride", GRAD_CASES)
def test_dx_plain_matches_pallas(shape, cout, stride):
    x, k, g = _grad_inputs(shape, cout, stride)
    out = tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), shape, stride).numpy()
    ref = np.asarray(jvjp._dx_pallas(jnp.asarray(g), jnp.asarray(k), shape, stride,
                                     interpret=True))
    assert out.shape == shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,cout,stride", GRAD_CASES)
def test_dk_plain_matches_pallas(shape, cout, stride):
    x, _, g = _grad_inputs(shape, cout, stride)
    out = tvjp.dk_plain(torch.from_numpy(x), torch.from_numpy(g), stride).numpy()
    ref = np.asarray(jvjp._dk_pallas(jnp.asarray(x), jnp.asarray(g), stride, interpret=True))
    assert out.shape == (3, 3, shape[-1], cout)
    # another f32 reduction order (one einsum against grid-accumulated
    # matmuls): the rtol 1e-3 of tests/test_sphere_conv_vjp.py:132
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("with_bias", [True, False])
def test_function_matches_jax_grad(stride, with_bias):
    rng = np.random.default_rng(0)
    b, h, w, cin, cout = 2, 16, 32, 8, 8
    x = rng.random((b, h, w, cin), dtype=np.float32)
    k = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    tgt = rng.random((b, h // stride, w // stride, cout), dtype=np.float32)

    def loss(x, k, bias):
        return jnp.sum((jvjp.sphere_conv_trainable(x, k, bias, stride) - tgt) ** 2)

    argnums = (0, 1, 2) if with_bias else (0, 1)
    v_ref, g_ref = jax.value_and_grad(loss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias) if with_bias else None)

    xt, kt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(k).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_() if with_bias else None
    out = tvjp.SphereConvFunction.apply(xt, kt, bt, stride)
    v = ((out - torch.from_numpy(tgt)) ** 2).sum()
    got = torch.autograd.grad(v, [t for t in (xt, kt, bt) if t is not None])
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=1e-5)
    for a, b_, name in zip(got, g_ref, ("dx", "dk", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4, atol=1e-4, err_msg=name)


def test_function_skips_unneeded_grads():
    """No dx for an input without a gradient (the SPADE guide branch), no dK
    for a frozen kernel (the discriminator in the generator step)."""
    x, k, g = _grad_inputs((1, 8, 16, 4), 6, 1)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k).requires_grad_()
    out = tsc.sphere_conv(xt, kt, None, 1)
    (gk,) = torch.autograd.grad(out, kt, torch.from_numpy(g))
    np.testing.assert_allclose(gk.numpy(), tvjp.dk_plain(xt, torch.from_numpy(g)).numpy(),
                               rtol=0, atol=0)
    xt = torch.from_numpy(x).requires_grad_()
    out = tsc.sphere_conv(xt, torch.from_numpy(k), None, 1)
    (gx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(
        gx.numpy(), tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), x.shape).numpy(),
        rtol=0, atol=0)


def test_cpu_grad_wrappers_take_the_plain_versions():
    x, k, g = _grad_inputs((1, 16, 32, 4), 6, 2)
    xt, kt, gt = (torch.from_numpy(a) for a in (x, k, g))
    before = (tker.sphere_conv_s2.launches, tker.sphere_conv_dx_s2.launches,
              tker.sphere_conv_dk.launches)
    torch.testing.assert_close(tker.sphere_conv_s2(xt, kt), tsc.sphere_conv_plain(xt, kt, None, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(tker.sphere_conv_dx(gt, kt, x.shape, 2),
                               tvjp.dx_plain(gt, kt, x.shape, 2), rtol=0, atol=0)
    torch.testing.assert_close(tker.sphere_conv_dk(xt, gt, 2), tvjp.dk_plain(xt, gt, 2),
                               rtol=0, atol=0)
    assert (tker.sphere_conv_s2.launches, tker.sphere_conv_dx_s2.launches,
            tker.sphere_conv_dk.launches) == before


def test_dk_chunks_cover_every_pixel():
    """B4's pixel chunks (``dk_plan``): whole 16-pixel slabs, every pixel in
    one chunk, no chunk empty."""
    for n_pix, cin, cout in [(8 * 32768, 128, 256), (256, 1024, 1024), (16 * 8192, 6, 64),
                             (17, 3, 3), (2 * 8 * 16, 512, 3)]:
        plan = tker.dk_plan(n_pix, cin, cout)
        chunk, n_chunks = plan.chunk, plan.n_chunks
        assert chunk % plan.slab == 0 and chunk * n_chunks >= n_pix > chunk * (n_chunks - 1)
