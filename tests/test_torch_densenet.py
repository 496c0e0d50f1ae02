"""Port of the DenseNet regressor (emlight_tpu_torch.nn.densenet) against the
JAX package's eval forward (regression.make_eval_apply, the buffer forward
the pipeline runs), with weights from R.create_state through the bridge."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from emlight_tpu.config import AnchorConfig, RegressionConfig
from emlight_tpu.train import regression as R
from emlight_tpu_torch import config as tcfg
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.jax_weights import densenet_state_from_jax
from torch_port_helpers import port_regression_cfg, randomize_stats

N_ANCHORS = 16
REG_HW = (48, 64)


@pytest.fixture(scope="module")
def jax_state():
    cfg = dataclasses.replace(
        RegressionConfig(), anchors=AnchorConfig(regression_anchors=N_ANCHORS),
        crop_h=REG_HW[0], crop_w=REG_HW[1], block_config=(2, 2),
    )
    state = R.create_state(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(np.asarray, state.params)
    stats = randomize_stats(jax.tree.map(np.asarray, state.batch_stats),
                            np.random.default_rng(1))
    return cfg, params, stats


def test_heads_match_jax(jax_state):
    cfg, params, stats = jax_state
    crop = np.random.default_rng(2).random((2, *REG_HW, 3), dtype=np.float32)
    ref = R.predict(R.make_eval_apply(cfg), params, stats, crop)

    model = TR.make_model(port_regression_cfg(cfg), device="cpu")
    model.load_state_dict(densenet_state_from_jax(params, stats), strict=True)
    out = TR.predict(model, torch.from_numpy(crop))
    assert set(out) == {"distribution", "intensity", "rgb_ratio", "ambient"}
    for k in out:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["AnchorConfig", "SinkhornConfig", "RegressionConfig",
                                  "ProjectorConfig"])
def test_config_fields_and_defaults_equal_jax(name):
    import emlight_tpu.config as jcfg

    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())


def test_full_width_fc_in_features():
    """The default 192x256 crop gives the reference's 8208-dim pooled vector."""
    model = TR.make_model(tcfg.RegressionConfig(), device="cpu")
    assert model.fc.in_features == 6 * 8 * 171
    assert model.fc_dist.out_features == 96
    assert not model.training


def test_regressor_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.make_model(tcfg.RegressionConfig())
