"""Shared helpers of the tests/test_torch_*.py files: JAX-initialised weights
as NumPy trees, and the port's config for a JAX config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from conftest import jit0
from emlight_tpu.train import projector as P
from emlight_tpu_torch import config as tcfg


def randomize_stats(tree, rng):
    """Nontrivial BatchNorm running statistics (fresh ones are 0 / 1)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = randomize_stats(val, rng)
        elif key == "mean":
            out[key] = rng.normal(0, 0.1, val.shape).astype(np.float32)
        else:
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    return out


def jax_generator_variables(cfg, seed: int):
    """The generator half of P.create_state(PRNGKey(seed), cfg): the same
    model and init call, jitted at XLA opt level 0 (P.create_state inits
    eagerly on the CPU, about 30 s per config, and the discriminator too).
    Returns (g_apply, params, stats) with NumPy leaves and randomized
    BatchNorm running statistics."""
    g, _ = P.make_models(cfg)
    env_h, env_w = cfg.crop_size // 2, cfg.crop_size
    guide = jnp.zeros((1, env_h, env_w, 3))
    crop = jnp.zeros((1, cfg.crop_size // 2, cfg.crop_size // 2, 3))
    kg, _ = jax.random.split(jax.random.PRNGKey(seed))
    if cfg.use_vae:
        kg1, kg2 = jax.random.split(kg)
        gv = jit0(lambda a, b: g.init({"params": a, "vae": b}, guide, crop, train=True))(kg1, kg2)
    else:
        gv = jit0(lambda k: g.init(k, guide, crop, train=True))(kg)
    gv = jax.tree.map(np.asarray, gv)
    params = gv.pop("params")
    gv["batch_stats"] = randomize_stats(gv["batch_stats"], np.random.default_rng(seed))
    return g.apply, params, gv


def port_anchor_cfg(a):
    return tcfg.AnchorConfig(**dataclasses.asdict(a))


def port_regression_cfg(cfg):
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("anchors", "sinkhorn")}
    return tcfg.RegressionConfig(anchors=port_anchor_cfg(cfg.anchors),
                                 sinkhorn=tcfg.SinkhornConfig(**dataclasses.asdict(cfg.sinkhorn)),
                                 **fields)


def port_projector_cfg(cfg):
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "anchors"}
    return tcfg.ProjectorConfig(anchors=port_anchor_cfg(cfg.anchors), **fields)
