"""The SPADE generator's variants in the port (emlight_tpu_torch.nn.spade)
against the JAX package's: the "more" and "most" upsampling layers and
instance norm (norm_G "spectralspadeinstance3x3"), each in an eval forward.

The weights are the port's seeded init, with BatchNorm running statistics
drawn away from 0 / 1, carried to the JAX generator by train/jax_weights.py
(``generator_tree_from_state``, the bridge the checkpoints use); the JAX
generator's init is not run (it would cost a compile per variant), but its
tree must take every leaf: flax's apply refuses a missing one.

Sizes: the smallest crop each variant takes (the latent is crop / 2^n wide
and half as high): "more" at crop 128 (64x128 maps), "most" at crop 256
(128x256 maps, with up_4 at ngf / 2), instance norm at crop 64; ngf 4 (2
for "most"), batch 1. The bar is tests/test_torch_spade.py's: rtol 1e-4,
atol 5e-4 (1e-5 of the (tanh+1)*25 range)."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import jit0
from emlight_tpu.config import AnchorConfig, ProjectorConfig
from emlight_tpu.train import projector as P
from emlight_tpu_torch.nn.sphere_conv import SphereConv2D
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train.jax_weights import generator_tree_from_state
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
)

VARIANTS = {
    "more": dict(num_upsampling_layers="more", crop_size=128, ngf=4),
    "most": dict(num_upsampling_layers="most", crop_size=256, ngf=2),
    "instance": dict(norm_g="spectralspadeinstance3x3", crop_size=64, ngf=4),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_generator_matches_jax(name):
    fields = VARIANTS[name]
    crop = fields["crop_size"]
    cfg = dataclasses.replace(ProjectorConfig(), ndf=4, **fields,
                              anchors=AnchorConfig(n_anchors=16, env_h=crop // 2, env_w=crop))
    g = TP.make_models(port_projector_cfg(cfg), device="cpu", seed=2)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for key, t in g.state_dict().items():
            if key.endswith(".mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif key.endswith(".var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    params, stats = generator_tree_from_state(g.state_dict())
    assert ("up_4" in params) == (name == "most")
    assert bool(stats["batch_stats"]) == (name != "instance")
    n_convs = sum(isinstance(m, SphereConv2D) for m in g.modules())
    assert n_convs == 44 + 7 * (name == "most")  # up_4: a shortcut block of 7 sphere convs
    jg, _ = P.make_models(cfg)

    rng = np.random.default_rng(5)
    guide = (rng.random((1, crop // 2, crop, 3)) * 4.0).astype(np.float32)
    crop_img = rng.random((1, crop // 2, crop // 2, 3), dtype=np.float32)
    variables = {"params": params, **{k: v for k, v in stats.items() if v}}
    ref = np.asarray(jit0(lambda v, a, c: jg.apply(v, a, c, train=False))(
        variables, guide, crop_img))
    with torch.inference_mode():
        out = g(torch.from_numpy(guide), torch.from_numpy(crop_img)).numpy()
    assert out.shape == ref.shape == (1, crop // 2, crop, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-4)
