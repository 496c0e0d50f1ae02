"""Port of the GAN objectives (emlight_tpu_torch.losses.gan) against the
JAX package: values and gradients of gan_loss (all four modes),
feature_matching_loss and cosine_loss, plus kld_loss. Inputs in f32 from a
seeded numpy generator; the bar is rtol 1e-5 / atol 1e-6 on values and
gradients (the same f32 reductions, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.losses import gan as jgan
from emlight_tpu_torch.losses import gan as tgan

TOL = dict(rtol=1e-5, atol=1e-6)


def _preds(seed, b=2, num_d=2, n_feat=3):
    """Per-D lists of NHWC activations, the last the logit map."""
    rng = np.random.default_rng(seed)
    out = []
    h, w = 16, 32
    for _ in range(num_d):
        per_d = [rng.standard_normal((b, h // 2 ** (j + 1), w // 2 ** (j + 1), 4 + j))
                 .astype(np.float32) for j in range(n_feat)]
        per_d.append(rng.standard_normal((b, h // 2 ** n_feat, w // 2 ** n_feat, 3))
                     .astype(np.float32))
        out.append(per_d)
        h, w = h // 2, w // 2
    return out


def _torch_tree(tree):
    return [[torch.from_numpy(a).requires_grad_() for a in per_d] for per_d in tree]


def _jax_tree(tree):
    return [[jnp.asarray(a) for a in per_d] for per_d in tree]


@pytest.mark.parametrize("mode,real,for_d", [
    ("hinge", True, True), ("hinge", False, True), ("hinge", True, False),
    ("ls", True, False), ("ls", False, True), ("original", True, True),
    ("original", False, True), ("w", True, False), ("w", False, True),
])
def test_gan_loss_matches_jax(mode, real, for_d):
    pred = _preds(1)
    v_ref, g_ref = jax.value_and_grad(
        lambda p: jgan.gan_loss(p, real, for_discriminator=for_d, mode=mode))(_jax_tree(pred))
    pt = _torch_tree(pred)
    v = tgan.gan_loss(pt, real, for_discriminator=for_d, mode=mode)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref), **TOL)
    for per_t, per_j in zip(pt, g_ref):
        for t, j in zip(per_t, per_j):
            got = np.zeros_like(np.asarray(j)) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(got, np.asarray(j), **TOL)


def test_gan_loss_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown gan mode"):
        tgan.gan_loss(_torch_tree(_preds(0)), True, False, mode="nope")


def test_feature_matching_matches_jax():
    fake, real = _preds(2), _preds(3)
    rng = np.random.default_rng(4)
    light = (rng.random((2, 16, 32, 1)) > 0.8).astype(np.float32)
    v_ref, g_ref = jax.value_and_grad(
        lambda f: jgan.feature_matching_loss(f, _jax_tree(real), jnp.asarray(light), 50.0))(
        _jax_tree(fake))
    ft, rt = _torch_tree(fake), _torch_tree(real)
    v = tgan.feature_matching_loss(ft, rt, torch.from_numpy(light), 50.0)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref), **TOL)
    for per_t, per_j in zip(ft, g_ref):
        for t, j in zip(per_t[:-1], per_j[:-1]):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)
        assert per_t[-1].grad is None  # the logit map is not matched
    # the real features are stop-gradient
    assert all(t.grad is None for per_t in rt for t in per_t)


def test_cosine_loss_matches_jax_with_zero_pixels():
    rng = np.random.default_rng(5)
    fake = rng.random((2, 8, 16, 3)).astype(np.float32)
    real = rng.random((2, 8, 16, 3)).astype(np.float32)
    fake[0, 0, :4] = 0.0  # saturated (tanh+1)*25 head: exactly zero pixels
    real[1, 3, 5] = 0.0
    v_ref, g_ref = jax.value_and_grad(jgan.cosine_loss)(jnp.asarray(fake), jnp.asarray(real))
    ft = torch.from_numpy(fake).requires_grad_()
    v = tgan.cosine_loss(ft, torch.from_numpy(real))
    v.backward()
    assert torch.isfinite(ft.grad).all()
    np.testing.assert_allclose(v.item(), float(v_ref), **TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(g_ref), **TOL)
    assert (ft.grad[0, 0, :4] == 0).all()


def test_kld_loss_matches_jax():
    rng = np.random.default_rng(6)
    mu = rng.standard_normal((2, 16)).astype(np.float32)
    logvar = rng.standard_normal((2, 16)).astype(np.float32) * 0.3
    ref = float(jgan.kld_loss(jnp.asarray(mu), jnp.asarray(logvar)))
    out = tgan.kld_loss(torch.from_numpy(mu), torch.from_numpy(logvar)).item()
    np.testing.assert_allclose(out, ref, **TOL)
