"""The port's crop -> HDR env map pipeline (emlight_tpu_torch.train.pipeline)
against the JAX package's pipeline_inference, at the config of
tests/test_pipeline.py:25-42; plus the port's isolation from JAX and its
refusal to fall back to the CPU silently."""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.config import AnchorConfig, ProjectorConfig, RegressionConfig
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu.train.pipeline import pipeline_inference as j_pipeline
from emlight_tpu_torch.train import pipeline as TPL
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.jax_weights import (
    densenet_state_from_jax,
    generator_state_from_jax,
)
from torch_port_helpers import (
    jax_generator_variables,
    port_projector_cfg,
    port_regression_cfg,
    randomize_stats,
)

N_ANCHORS = 16
CROP_SIZE = 64  # generator output (32, 64), encoder input 32x32
REG_HW = (48, 64)


@pytest.fixture(scope="module")
def models():
    reg_cfg = dataclasses.replace(
        RegressionConfig(), anchors=AnchorConfig(regression_anchors=N_ANCHORS),
        crop_h=REG_HW[0], crop_w=REG_HW[1], block_config=(2,),
    )
    proj_cfg = dataclasses.replace(
        ProjectorConfig(), crop_size=CROP_SIZE, ngf=4, ndf=4,
        anchors=AnchorConfig(n_anchors=N_ANCHORS, env_h=CROP_SIZE // 2, env_w=CROP_SIZE),
    )
    reg_state = R.create_state(jax.random.PRNGKey(0), reg_cfg)
    reg_state = reg_state.replace(batch_stats=randomize_stats(
        jax.tree.map(np.asarray, reg_state.batch_stats), np.random.default_rng(0)))
    g_apply, g_params, g_stats = jax_generator_variables(proj_cfg, seed=1)
    proj_state = P.ProjectorState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_stats=g_stats, d_params={},
        d_stats={}, g_opt=None, d_opt=None, tx_g=None, tx_d=None, g_apply=g_apply,
        d_apply=None,
    )

    regressor = TR.make_model(port_regression_cfg(reg_cfg), device="cpu")
    regressor.load_state_dict(densenet_state_from_jax(
        jax.tree.map(np.asarray, reg_state.params), reg_state.batch_stats))
    generator = TP.make_models(port_projector_cfg(proj_cfg), device="cpu")
    generator.load_state_dict(generator_state_from_jax(g_params, g_stats))
    return reg_cfg, proj_cfg, reg_state, proj_state, regressor, generator


def _crops(batch, seed=0):
    rng = np.random.default_rng(seed)
    crop_reg = rng.random((batch, *REG_HW, 3), dtype=np.float32)
    crop_proj = rng.random((batch, CROP_SIZE // 2, CROP_SIZE // 2, 3), dtype=np.float32)
    return crop_reg, crop_proj


def test_pipeline_matches_jax(models):
    reg_cfg, proj_cfg, reg_state, proj_state, regressor, generator = models
    crop_reg, crop_proj = _crops(2)
    env_ref, pred_ref = j_pipeline(reg_state, proj_state, crop_reg, crop_proj,
                                   reg_cfg, proj_cfg)
    env, pred = TPL.pipeline_inference(
        regressor, generator, crop_reg, crop_proj, port_regression_cfg(reg_cfg),
        port_projector_cfg(proj_cfg), device="cpu")
    assert env.shape == (2, CROP_SIZE // 2, CROP_SIZE, 3)
    np.testing.assert_allclose(env.numpy(), np.asarray(env_ref), rtol=1e-4, atol=5e-4)
    assert set(pred) == set(pred_ref)
    for k in pred:
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(pred_ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_make_guide_matches_jax(models):
    """The projector's training guide (anchor GT x alpha), port vs JAX."""
    _, proj_cfg, *_ = models
    rng = np.random.default_rng(3)
    b = 2
    dist = rng.gamma(0.3, 1.0, (b, N_ANCHORS)).astype(np.float32)
    batch = {
        "distribution": dist / dist.sum(1, keepdims=True),
        "intensity": rng.uniform(1, 50, b).astype(np.float32),
        "rgb_ratio": rng.uniform(0.3, 0.8, (b, 3)).astype(np.float32),
        "ambient": rng.uniform(0, 0.05, (b, 3)).astype(np.float32),
        "alpha": rng.uniform(0.5, 2.0, b).astype(np.float32),
    }
    ref = np.asarray(jax.jit(P.make_guide, static_argnums=1)(batch, proj_cfg))
    out = TP.make_guide({k: torch.from_numpy(v) for k, v in batch.items()},
                        port_projector_cfg(proj_cfg)).numpy()
    # 1e-4: at the suite's XLA opt level 0 the reference's logits round an
    # ulp differently, which the 1/size = 400 exponent scale turns into 2.4e-5
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


def test_projector_inference_matches_jax(models):
    """Eval generation from an anchor-GT batch (guide x alpha + crop)."""
    _, proj_cfg, _, proj_state, _, generator = models
    rng = np.random.default_rng(4)
    b = 2
    dist = rng.gamma(0.3, 1.0, (b, N_ANCHORS)).astype(np.float32)
    batch = {
        "distribution": dist / dist.sum(1, keepdims=True),
        "intensity": rng.uniform(1, 50, b).astype(np.float32),
        "rgb_ratio": rng.uniform(0.3, 0.8, (b, 3)).astype(np.float32),
        "ambient": rng.uniform(0, 0.05, (b, 3)).astype(np.float32),
        "alpha": rng.uniform(0.5, 2.0, b).astype(np.float32),
        "crop": rng.random((b, CROP_SIZE // 2, CROP_SIZE // 2, 3), dtype=np.float32),
    }
    ref = np.asarray(P.inference(proj_state, batch, proj_cfg))
    out = TP.inference(generator, {k: torch.from_numpy(v) for k, v in batch.items()},
                       port_projector_cfg(proj_cfg)).numpy()
    assert out.shape == (b, CROP_SIZE // 2, CROP_SIZE, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-4)


def test_pipeline_requires_cuda_unless_cpu_is_asked(models, monkeypatch):
    reg_cfg, proj_cfg, _, _, regressor, generator = models
    crop_reg, crop_proj = _crops(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPL.pipeline_inference(regressor, generator, crop_reg, crop_proj,
                               port_regression_cfg(reg_cfg), port_projector_cfg(proj_cfg))


def test_pipeline_rejects_models_on_another_device(models):
    reg_cfg, proj_cfg, _, _, regressor, generator = models
    crop_reg, crop_proj = _crops(1)
    with pytest.raises(ValueError, match="regressor lives on cpu"):
        TPL.pipeline_inference(regressor, generator, crop_reg, crop_proj,
                               port_regression_cfg(reg_cfg), port_projector_cfg(proj_cfg),
                               device="meta")


def test_port_imports_nothing_of_jax():
    """Every module of the port, the CLIs, the loop services, the native
    EXR codec, the needlets and the reference oracle included, imports
    nothing of JAX or the JAX package, and nothing the card's machine lacks
    (msgpack, PIL, cv2, imageio: the port has its own msgpack codec, PNG
    writer and area resize; scipy, which the needlets use, it has)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import emlight_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(emlight_tpu_torch.__path__,
                                                       "emlight_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for cli in ("infer", "test_regression", "train_regression", "train_projector",
                    "test_projector", "eval_projector", "eval_metrics", "extract_distribution",
                    "needlets_gt", "fit_single", "verify_parity", "sphere_demo", "preview",
                    "modify_pickles"):
            assert f"emlight_tpu_torch.cli.{cli}" in names, names
        for mod in ("native", "train.loop", "train.data", "train.checkpoint",
                    "needlets.pipeline", "train.torch_ref", "dist.auto"):
            assert f"emlight_tpu_torch.{mod}" in names, names
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "emlight_tpu",
                                            "msgpack", "PIL", "cv2", "imageio"))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 70  # every module was imported
