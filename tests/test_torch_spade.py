"""Port of the SPADE generator (emlight_tpu_torch.nn.spade) and the splat
renderer against the JAX package, with weights from the JAX generator's init
(the generator half of P.create_state) through the bridge. ngf 4,
crop_size 64: the output is 32x64 = 2048 px, so up_3 and sphere_conv1 sit on
the JAX kernel's side of its pixel gate."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.config import AnchorConfig, ProjectorConfig
from emlight_tpu.representation.splat import render_anchor_params as j_render
from emlight_tpu_torch import config as tcfg
from emlight_tpu_torch.nn import layers as tlayers
from emlight_tpu_torch.representation.splat import render_anchor_params as t_render
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train.jax_weights import generator_state_from_jax
from torch_port_helpers import (  # noqa: F401 (the fixture: autouse)
    jax_generator_variables,
    no_persistent_cache_writes,
    port_projector_cfg,
)

CROP = 64
N_ANCHORS = 16


def jax_cfg(use_vae):
    return dataclasses.replace(
        ProjectorConfig(), crop_size=CROP, ngf=4, ndf=4, use_vae=use_vae,
        anchors=AnchorConfig(n_anchors=N_ANCHORS, env_h=CROP // 2, env_w=CROP),
    )


def generator_pair(use_vae, seed=1):
    """(jax apply, jax variables, port generator) with the same weights."""
    cfg = jax_cfg(use_vae)
    g_apply, params, stats = jax_generator_variables(cfg, seed)
    g = TP.make_models(port_projector_cfg(cfg), device="cpu")
    g.load_state_dict(generator_state_from_jax(params, stats), strict=True)
    return g_apply, {"params": params, **stats}, g


def _guide_and_crop(b=2, seed=0):
    rng = np.random.default_rng(seed)
    guide = (rng.random((b, CROP // 2, CROP, 3)) * 4.0).astype(np.float32)
    crop = rng.random((b, CROP // 2, CROP // 2, 3), dtype=np.float32)
    return guide, crop


@pytest.mark.parametrize("use_vae", [False, True])
def test_generator_matches_jax(use_vae):
    g_apply, variables, g = generator_pair(use_vae)
    guide, crop = _guide_and_crop()
    ref = np.asarray(jax.jit(lambda v, a, c: g_apply(v, a, c, train=False))(
        variables, guide, crop))
    with torch.inference_mode():
        out = g(torch.from_numpy(guide), torch.from_numpy(crop)).numpy()
    assert out.shape == (2, CROP // 2, CROP, 3)
    # outputs span 0-50: atol 5e-4 is 1e-5 of the range
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-4)


def test_render_anchor_params_matches_jax():
    rng = np.random.default_rng(3)
    b = 2
    dist = rng.gamma(0.3, 1.0, (b, N_ANCHORS)).astype(np.float32)
    dist /= dist.sum(1, keepdims=True)
    inten = rng.uniform(1, 50, b).astype(np.float32)
    rgb = rng.uniform(0.3, 0.8, (b, 3)).astype(np.float32)
    amb = rng.uniform(0, 0.1, (b, 3)).astype(np.float32)
    kw = dict(n=N_ANCHORS, h=CROP // 2, w=CROP, size=0.0025, intensity_scale=5.0)
    args = [jnp.asarray(a) for a in (dist, inten, rgb, amb)]
    # The reference as it runs outside the test suite: at conftest's XLA
    # optimization level 0 the direction matmul rounds differently, and one
    # ulp of a logit, scaled by 1/size = 400 in the exponent, is 2.4e-5 of
    # the map — above this 2e-5 bar.
    compiled = j_render.lower(*args, **kw).compile(
        compiler_options={"xla_backend_optimization_level": 3})
    ref = np.asarray(compiled(*args, size=kw["size"]))
    out = t_render(*(torch.from_numpy(a) for a in (dist, inten, rgb, amb)), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-6)


def test_spectral_sigma_uses_hwio_flatten_of_oihw_weight():
    """SNConv keeps an OIHW weight; sigma = u^T W v must use v in the
    (kh, kw, in) order of the JAX package's HWIO kernel."""
    from emlight_tpu_torch.nn.spade import SNConv

    conv = SNConv(5, 7, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    conv.u.copy_(torch.from_numpy(rng.normal(size=7).astype(np.float32)))
    conv.v.copy_(torch.from_numpy(rng.normal(size=45).astype(np.float32)))
    hwio = conv.weight.detach().permute(2, 3, 1, 0).numpy()
    want = conv.u.numpy() @ hwio.reshape(-1, 7).T @ conv.v.numpy()
    got = tlayers.spectral_sigma(conv.weight.detach().permute(2, 3, 1, 0), conv.u, conv.v)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_full_width_generator_shape_and_parameter_count():
    """ProjectorConfig() defaults: 118.3 M generator parameters, like the
    JAX generator at ngf 64; 44 stride-1 sphere convs per forward."""
    from emlight_tpu_torch.nn.sphere_conv import SphereConv2D

    g = TP.make_models(tcfg.ProjectorConfig(), device="cpu")
    n = sum(p.numel() for p in g.parameters())
    assert abs(n / 1e6 - 118.3) < 0.05, n
    convs = [m for m in g.modules() if isinstance(m, SphereConv2D)]
    assert len(convs) == 44 and all(m.stride == 1 for m in convs)


def test_generator_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.make_models(tcfg.ProjectorConfig(ngf=4, crop_size=64))


class _VaeDraw(fnn.Module):
    """The JAX generator's latent draw: make_rng("vae") once at the root
    scope."""

    @fnn.compact
    def __call__(self, shape):
        return jax.random.normal(self.make_rng("vae"), shape)


def test_generator_is_eval_only():
    """A use_vae generator: eval takes z = mu; train mode the reparameterized
    z = mu + eps * exp(logvar / 2), as the JAX generator does with the same
    eps (its draw at the root scope, recovered with the same key), and
    hands (mu, logvar) back for the KLD term. (Until use_vae training was
    ported, train mode raised.)"""
    g_apply, variables, g = generator_pair(True)
    variables = {k: v for k, v in variables.items() if k != "vae_stats"}
    guide, crop = _guide_and_crop(2)
    key = jax.random.PRNGKey(7)

    def train_apply(v, a, c):
        out, mut = g_apply(v, a, c, train=True, rngs={"vae": key},
                           mutable=["batch_stats", "spectral", "vae_stats"])
        return out, mut["vae_stats"]["mu"][0], mut["vae_stats"]["logvar"][0]

    ref, mu, logvar = jax.jit(train_apply)(variables, guide, crop)
    # the same draw: one make_rng("vae") at the root scope with the same key
    eps = np.asarray(_VaeDraw().apply({}, (2, 32 * g.ngf), rngs={"vae": key}))
    out, (t_mu, t_logvar) = g.train()(torch.from_numpy(guide), torch.from_numpy(crop),
                                      eps=torch.tensor(eps), want_vae=True)
    np.testing.assert_allclose(t_mu.detach().numpy(), np.asarray(mu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_logvar.detach().numpy(), np.asarray(logvar), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=5e-4)
    with torch.no_grad():  # eval: z = mu, whatever eps is given
        g.eval()
        a = g(torch.from_numpy(guide), torch.from_numpy(crop))
        b = g(torch.from_numpy(guide), torch.from_numpy(crop), eps=torch.tensor(eps))
    assert torch.equal(a, b)


def test_tables_made_while_serving_serve_a_training_step():
    """The resize and splat tables go onto the device once per size; one
    first made under inference_mode (serving) must still be saved for a
    training step's backward (an inference tensor cannot be)."""
    from emlight_tpu_torch.representation import splat as tsplat
    from emlight_tpu_torch.train.data import synthetic_projector_batch

    for cached in (tlayers._nearest_index, tlayers._axis_weights, tsplat._anchors,
                   tsplat._grid):
        cached.cache_clear()
    cfg = port_projector_cfg(jax_cfg(False))
    batch = synthetic_projector_batch(2, n_anchors=N_ANCHORS, crop_size=CROP // 2,
                                      env_hw=(CROP // 2, CROP), seed=2)
    TP.inference(TP.make_models(cfg, device="cpu"),
                 {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    losses, fake = TP.generator_step(TP.create_state(cfg, device="cpu"), batch)
    assert torch.isfinite(losses["loss_G"]) and fake.shape == (2, CROP // 2, CROP, 3)
