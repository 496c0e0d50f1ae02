"""Shared helpers of the tests/test_torch_*.py files: JAX-initialised weights
as NumPy trees, the port's config for a JAX config, a fixture that runs a
module's torch work on one thread, and the NumPy emulation of the tensor-core
kernels' f32 products (3xTF32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the importing module: its small shapes
    gain nothing from more, and the suite runs several worker processes on
    the same cores, where torch's thread pools contend (measured: a 9-step
    loop of 0.5 s took 75 s with 4 workers). The setting is restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return r.astype(np.uint32).view(np.float32)


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernels take an f32 product on the tensor cores: each
    operand split into TF32 hi and lo, lo*hi + hi*lo + hi*hi in f32."""
    ah = tf32(a)
    al = tf32(a - ah)
    bh = tf32(b)
    bl = tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def matmul_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32(a) @ tf32(b)


def tf32_cut(a: np.ndarray) -> np.ndarray:
    """f32 cut to TF32 (10 mantissa bits) toward zero: the bits the tensor
    cores read of a TF32 operand."""
    return (np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_3xtf32_cut(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as B3 and B4 take an f32 product on the tensor cores: each
    operand split as hi = v cut to TF32, lo = v - hi (exact), of which the
    tensor cores read lo cut to TF32; lo*hi + hi*lo + hi*hi in f32."""
    ah = tf32_cut(a)
    al = tf32_cut(a - ah)
    bh = tf32_cut(b)
    bl = tf32_cut(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh
