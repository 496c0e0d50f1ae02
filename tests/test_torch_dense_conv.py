"""Port of the dense layer's fused affine 3x3 conv (emlight_tpu_torch.nn.
dense_conv) against the JAX package, in float64 on the CPU, where the port
takes its plain versions: the forward and all four gradients (x, a, b,
kernel) of ``fused_affine_conv3x3`` against JAX's ``conv3x3_nhwc_reference``
under jax.grad, at rtol 1e-9 / atol 1e-10, the bars of
tests/test_densenet_fast.py:205; once against JAX's Pallas kernels
(``fused_affine_conv3x3(..., True)``, interpret mode) at that test's shape;
and at shapes JAX's ``supported()`` rejects (h % 8 != 0, h == 8, one pixel),
where only the XLA reference is right."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import dense_conv_pallas as J
from emlight_tpu_torch.nn import dense_conv as T
from emlight_tpu_torch.nn import dense_conv_kernel as TK
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-9, 1e-10


def _x64():
    from jax._src.config import enable_x64  # no public context manager yet

    return enable_x64(True)


def _inputs(b, h, w, c, o, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)), rng.standard_normal(c) * 0.5 + 1.0,
            rng.standard_normal(c) * 0.1, rng.standard_normal((3, 3, c, o)),
            rng.standard_normal((b, h, w, o)))


def _jax_value_and_grads(fn, arrays):
    x, a, b, k, ct = (jnp.asarray(v) for v in arrays)
    out = jax.jit(fn)(x, a, b, k)
    grads = jax.jit(jax.grad(lambda *A: jnp.sum(fn(*A) * ct), argnums=(0, 1, 2, 3)))(x, a, b, k)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_value_and_grads(arrays):
    x, a, b, k, ct = (torch.from_numpy(v) for v in arrays)
    args = [t.requires_grad_() for t in (x, a, b, k)]
    out = T.fused_affine_conv3x3(*args)
    grads = torch.autograd.grad((out * ct).sum(), args)
    return out.detach().numpy(), [g.numpy() for g in grads]


# (B, H, W, Cin, Cout): the JAX test's shape, the dense layer's widths, and
# shapes supported() rejects: h % 8 != 0 (h = 10), h == 8, a single pixel
SHAPES = [(2, 16, 24, 5, 3), (2, 16, 20, 48, 12), (2, 10, 12, 5, 3), (1, 8, 16, 6, 4),
          (1, 1, 1, 3, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_grads_match_the_jax_reference(shape):
    arrays = _inputs(*shape)
    with _x64():
        ref, ref_grads = _jax_value_and_grads(J.conv3x3_nhwc_reference, arrays)
    out, grads = _port_value_and_grads(arrays)
    assert out.dtype == np.float64 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    for name, g, r in zip("xabk", grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


def test_forward_and_grads_match_the_jax_pallas_kernels():
    """JAX's fused kernels in interpret mode, at the smallest shape of
    tests/test_densenet_fast.py:205 (which it supports)."""
    arrays = _inputs(2, 16, 24, 5, 3)
    assert J.supported(16, 24)
    with _x64():
        ref, ref_grads = _jax_value_and_grads(
            lambda *A: J.fused_affine_conv3x3(*A, True), arrays)
    out, grads = _port_value_and_grads(arrays)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    for name, g, r in zip("xabk", grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


def test_zero_padding_is_of_y_not_of_x():
    """The border is 0 after the affine: a constant x = 0 with b = 1 gives a
    plain 3x3 box sum of the kernel inside and fewer taps at the edges."""
    x = torch.zeros(1, 3, 3, 1, dtype=torch.float64)
    k = torch.ones(3, 3, 1, 1, dtype=torch.float64)
    out = T.fused_affine_conv3x3(x, torch.ones(1, dtype=torch.float64),
                                 torch.ones(1, dtype=torch.float64), k)
    np.testing.assert_array_equal(out[0, :, :, 0].numpy(), [[4, 6, 4], [6, 9, 6], [4, 6, 4]])


def test_cpu_tensors_take_the_plain_versions():
    arrays = [torch.from_numpy(v.astype(np.float32)) for v in _inputs(1, 8, 8, 4, 2)]
    x, a, b, k, g = arrays
    before = [f.launches for f in (TK.dense_conv_fwd, TK.dense_conv_dx, TK.dense_conv_dk)]
    torch.testing.assert_close(TK.dense_conv_fwd(x, a, b, k), T.conv3x3_nhwc_reference(x, a, b, k))
    for got, ref in zip(TK.dense_conv_dx(g, x, a, k), T.conv3x3_dx_plain(g, x, a, k)):
        torch.testing.assert_close(got, ref)
    torch.testing.assert_close(TK.dense_conv_dk(x, g, a, b), T.conv3x3_dk_plain(x, g, a, b))
    assert [f.launches for f in (TK.dense_conv_fwd, TK.dense_conv_dx, TK.dense_conv_dk)] == before
