"""Port of the multiscale discriminator (emlight_tpu_torch.nn.discriminator)
against the JAX package, with weights from the JAX init through the bridge:
ndf 8, num_d 2, n_layers 4, on 32x64 maps of guide + env map (6 channels),
so the second scale runs its convs down to 2x4. Per-layer features in eval
and train mode, and the spectral-norm u, v a train-mode forward leaves."""

import jax
import numpy as np
import pytest
import torch

from conftest import jit0
from emlight_tpu.nn import discriminator as jdisc
from emlight_tpu.nn import layers as jlayers
from emlight_tpu_torch.nn import discriminator as tdisc
from emlight_tpu_torch.nn import layers as tlayers
from emlight_tpu_torch.train.jax_weights import discriminator_state_from_jax

NDF, NUM_D, N_LAYERS = 8, 2, 4
# five sphere convs and two instance norms deep, features O(1), f32 sums in
# other orders: rtol 1e-4 (the generator test's bar), atol 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    d = jdisc.MultiscaleDiscriminator(ndf=NDF, num_d=NUM_D, n_layers=N_LAYERS)
    x0 = np.zeros((2, 32, 64, 6), np.float32)
    variables = jax.tree.map(np.asarray, jit0(lambda k, x: d.init(k, x, train=True))(
        jax.random.PRNGKey(3), x0))
    params = variables.pop("params")
    port = tdisc.MultiscaleDiscriminator(6, NDF, NUM_D, N_LAYERS)
    port.load_state_dict(discriminator_state_from_jax(params, variables), strict=True)
    return d, params, variables, port


def _x(seed=0):
    return np.random.default_rng(seed).random((2, 32, 64, 6), dtype=np.float32) * 4.0


def _compare(out, ref):
    assert len(out) == len(ref) == NUM_D
    for per_t, per_j in zip(out, ref):
        assert len(per_t) == len(per_j) == N_LAYERS + 1
        for t, j in zip(per_t, per_j):
            assert tuple(t.shape) == np.asarray(j).shape
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_features_match_jax_eval(pair):
    d, params, stats, port = pair
    x = _x(1)
    ref = jit0(lambda v, x: d.apply(v, x, train=False))({"params": params, **stats}, x)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    _compare(out, ref)
    # the shapes of the multiscale pyramid: strides 2, 2, 2, 1, 1 per scale
    assert [tuple(o[-1].shape) for o in out] == [(2, 4, 8, 3), (2, 2, 4, 3)]


def test_train_forward_matches_jax_and_updates_uv(pair):
    d, params, stats, _ = pair
    port = tdisc.MultiscaleDiscriminator(6, NDF, NUM_D, N_LAYERS)
    port.load_state_dict(discriminator_state_from_jax(params, stats), strict=True)
    x = _x(2)
    ref, mut = jit0(lambda v, x: d.apply(v, x, train=True, mutable=["spectral"]))(
        {"params": params, **stats}, x)
    u_before = {k: v.clone() for k, v in port.state_dict().items() if k.endswith(".u")}
    with torch.no_grad():
        out = port.train()(torch.from_numpy(x))
    _compare(out, ref)
    new = discriminator_state_from_jax(params, jax.tree.map(np.asarray, mut))
    sd = port.state_dict()
    n_uv = 0
    for key, val in new.items():
        if key.endswith((".u", ".v")):
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
            n_uv += 1
    assert n_uv == 2 * NUM_D * (N_LAYERS - 1)
    assert all(not torch.equal(u_before[k], sd[k]) for k in u_before)


def test_avg_pool_3x3s2_matches_jax():
    x = _x(4)
    ref = np.asarray(jlayers.avg_pool_3x3s2(x))
    out = tlayers.avg_pool_3x3s2(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 16, 32, 6)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
