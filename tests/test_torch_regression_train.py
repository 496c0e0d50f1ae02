"""Port of regression training (emlight_tpu_torch.train.regression) against
the JAX package, at the SMALL config of tests/test_regression_train.py (crop
64x64, batch 2, blocks (2, 2), 96 anchors, default Sinkhorn), with the
weights and randomized BatchNorm running statistics of the JAX package's
create_state carried across by the bridge, and log_grad_norms on.

One train_step runs on both sides from the same state and batch. Compared:
the five loss terms and their total, EVERY gradient leaf, the gradient-norm
metrics, and the BatchNorm running statistics the step leaves (the port's
running variance must be the biased one flax keeps). Parameters after the
Adam update are not compared: the first Adam step moves each parameter by
about lr * sign(g), which hides the gradient. The JAX gradients are read
exactly by running the JAX step with an optax transformation whose update is
zero and whose state is the gradient. eval_step is compared on the state
before the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emlight_tpu.config import RegressionConfig
from emlight_tpu.train import regression as R
from emlight_tpu.train.data import synthetic_regression_batch as j_batch
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.data import synthetic_regression_batch as t_batch
from emlight_tpu_torch.train.jax_weights import densenet_grads_from_jax, densenet_state_from_jax
from torch_port_helpers import one_torch_thread, port_regression_cfg, randomize_stats  # noqa: F401

SMALL = dataclasses.replace(RegressionConfig(), crop_h=64, crop_w=64, batch_size=2,
                            block_config=(2, 2), log_grad_norms=True)

# Tolerances, all f32. The two sides sum in other orders, and the port's
# fused norm2 computes y = x * A + B where flax computes (x - mean) * mul +
# bias; the differences pass through 12 batch norms and the Sinkhorn loop.
# Losses and metrics: rtol 1e-4. Running statistics: rtol 2e-5 + atol 1e-6:
# tight enough to see the unbiased variance, which differs from the biased
# one by 0.1 / (N - 1) relative, 2e-4 at the 16x16 last_norm2 (N = 512).
# Gradients: each leaf within 2e-4 of its own largest magnitude (measured: at
# most 3.6e-5), but never of less than 1e-2 of the model's largest gradient:
# some leaves are zero in exact arithmetic and hold only rounding noise
# (norm0's and last_norm1's scale and shift: a batch norm follows them with
# nothing that breaks its scale invariance; measured 5.6e-7 of the model's
# largest gradient).
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_REL = 2e-4
GRAD_FLOOR = 1e-2
LOSS_KEYS = ("loss", "dist_emloss", "dist_l2loss", "intensity_loss", "rgb_loss", "ambient_loss")
NORM_KEYS = ("grad_norm",) + tuple(f"grad_norm_{h}" for h in TR.HEADS)


def _capture():
    """Zero update; the optimizer state is the gradient of the last step."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    """Both sides' eval_step and train_step; returns what the tests compare."""
    batch = j_batch(SMALL.batch_size, 96, (SMALL.crop_h, SMALL.crop_w), seed=3)
    assert all(np.array_equal(v, t_batch(SMALL.batch_size, 96, (64, 64), seed=3)[k])
               for k, v in batch.items())
    s0 = R.create_state(jax.random.PRNGKey(0), SMALL)
    stats0 = randomize_stats(_np(s0.batch_stats), np.random.default_rng(1))
    tx = _capture()
    s0 = s0.replace(tx=tx, opt_state=tx.init(s0.params), batch_stats=stats0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_eval, j_pred = R.eval_step(s0, jbatch, SMALL)
    s1, j_metrics = R.train_step(s0, jbatch, SMALL)

    state = TR.create_state(port_regression_cfg(SMALL), device="cpu")
    state.model.load_state_dict(densenet_state_from_jax(_np(s0.params), stats0))
    t_eval, t_pred = TR.eval_step(state, batch)
    t_metrics = TR.train_step(state, batch)
    return {
        "eval": (_np(j_eval), {k: v.numpy() for k, v in t_eval.items()}),
        "pred": (_np(j_pred), {k: v.numpy() for k, v in t_pred.items()}),
        "metrics": (_np(j_metrics), {k: v.numpy() for k, v in t_metrics.items()}),
        "grads": (densenet_grads_from_jax(_np(s1.opt_state)),
                  {n: p.grad.clone() for n, p in state.model.named_parameters()}),
        "stats": (densenet_state_from_jax(_np(s1.params), _np(s1.batch_stats)),
                  state.model.state_dict()),
    }


def test_train_step_losses_match_jax(run):
    ref, got = run["metrics"]
    assert set(got) == set(LOSS_KEYS + NORM_KEYS)
    for k in LOSS_KEYS + NORM_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)


def test_every_gradient_leaf_matches_jax(run):
    ref, got = run["grads"]
    assert set(got) == set(ref)
    scale = max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        err = (got[name] - r).abs().max().item()
        assert err <= GRAD_REL * max(r.abs().max().item(), GRAD_FLOOR * scale), (name, err)


def test_running_statistics_match_jax(run):
    """The batch statistics after one step, every BatchNorm of the model. The
    variance kept is flax's biased one, not nn.BatchNorm2d's unbiased one."""
    ref, got = run["stats"]
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 13
    for k in keys:
        torch.testing.assert_close(got[k], ref[k], **STATE_TOL, msg=lambda m: f"{k}: {m}")


def test_eval_step_matches_jax(run):
    ref, got = run["eval"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
    pref, pgot = run["pred"]
    for k in pref:
        np.testing.assert_allclose(pgot[k], pref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_loss_falls_on_one_batch():
    """Eight Adam steps on one fixed batch lower the loss, as
    tests/test_regression_train.py:56 shows for the JAX package."""
    cfg = port_regression_cfg(dataclasses.replace(SMALL, log_grad_norms=False))
    state = TR.create_state(cfg, device="cpu", seed=0)
    batch = t_batch(cfg.batch_size, 96, (cfg.crop_h, cfg.crop_w), seed=0)
    first = TR.train_step(state, batch)["loss"].item()
    for _ in range(8):
        metrics = TR.train_step(state, batch)
    assert state.step == 9
    assert metrics["loss"].item() < first
    assert all(np.isfinite(v.item()) for v in metrics.values())


def test_clip_grad_norm_bounds_the_update():
    """With clip_grad_norm set, the gradients Adam sees have at most that
    global norm (optax.clip_by_global_norm in front of Adam)."""
    cfg = port_regression_cfg(dataclasses.replace(SMALL, clip_grad_norm=0.5))
    state = TR.create_state(cfg, device="cpu", seed=1)
    metrics = TR.train_step(state, t_batch(2, 96, (64, 64), seed=2))
    assert metrics["grad_norm"].item() > 0.5
    norm = torch.linalg.vector_norm(
        torch.stack([p.grad.norm() for p in state.model.parameters()]))
    np.testing.assert_allclose(norm.item(), 0.5, rtol=1e-5)


def test_train_step_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.create_state(port_regression_cfg(SMALL))
