"""Port of the Sinkhorn anchor loss (emlight_tpu_torch.losses.sinkhorn)
against the JAX package's, in float64 at B 4, N 96: value and gradient for a
static diameter (the reference's exact schedule), a diameter taken from the
data (the clamped 12-step schedule) and the GMLight ``geometry=`` cost, at
the bars of the JAX package's own tests (tests/test_sinkhorn.py:89, :102,
:112, :163); the ε schedule and the cost matrices exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.losses import sinkhorn as J
from emlight_tpu_torch.losses import sinkhorn as T
from torch_port_helpers import one_torch_thread  # noqa: F401

# (value rtol, value atol, gradient rtol, gradient atol): the JAX tests' bars
BARS = {
    "static": (1e-4, 1e-6, 2e-3, 1e-6),     # tests/test_sinkhorn.py:89 and :102
    "dynamic": (5e-3, 1e-5, 2e-3, 1e-6),    # :112, gradient as :102
    "geometry": (1e-5, 1e-8, 2e-3, 1e-6),   # :163, gradient as :102
}


def _x64():
    from jax._src.config import enable_x64  # no public context manager yet

    return enable_x64(True)


def _dists(b=4, n=96, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.random((b, n))
    y = rng.random((b, n))
    return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)


@pytest.mark.parametrize("variant", list(BARS))
def test_value_and_gradient_match_jax(variant):
    x, y = _dists()
    depth = np.random.default_rng(0).uniform(0.5, 2.0, (4, 96))
    kw = {"static": dict(diameter=1.37), "dynamic": dict(diameter=None),
          "geometry": dict(diameter=None)}[variant]
    with _x64():
        jgeo = jnp.asarray(depth) if variant == "geometry" else None
        jloss = J.SamplesLoss("sinkhorn", blur=0.025, n_anchors=96, **kw)
        jval, jgrad = jax.jit(jax.value_and_grad(
            lambda a: jloss(a[..., None], jnp.asarray(y)[..., None], geometry=jgeo).sum()))(
                jnp.asarray(x))
        jvals = np.asarray(jax.jit(lambda a: jloss(a, jnp.asarray(y), geometry=jgeo))(
            jnp.asarray(x)))
    tloss = T.SamplesLoss("sinkhorn", blur=0.025, n_anchors=96, **kw)
    tgeo = torch.from_numpy(depth) if variant == "geometry" else None
    xt = torch.from_numpy(x).requires_grad_()
    tvals = tloss(xt[..., None], torch.from_numpy(y)[..., None], geometry=tgeo)
    tvals.sum().backward()
    vr, va, gr, ga = BARS[variant]
    assert tvals.dtype == torch.float64 and tvals.shape == (4,)
    np.testing.assert_allclose(tvals.detach().numpy(), jvals, rtol=vr, atol=va)
    np.testing.assert_allclose(tvals.sum().item(), float(jval), rtol=vr, atol=va)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=gr, atol=ga)


def test_epsilon_schedules_match_jax_exactly():
    for p, d, blur, scaling in ((2.0, 1.37, 0.025, 0.5), (2.0, 0.2, 0.025, 0.5),
                                (1.0, 3.0, 0.05, 0.7)):
        np.testing.assert_array_equal(T.epsilon_schedule(p, d, blur, scaling),
                                      J.epsilon_schedule(p, d, blur, scaling))
    for d in (0.9, 0.01):
        ref = np.asarray(J._clamped_schedule(jnp.float32(d), 2.0, 0.025, 0.5, 12))
        got = T._clamped_schedule(torch.tensor(d, dtype=torch.float32), 2.0, 0.025, 0.5, 12)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_cost_matrices_match_jax():
    np.testing.assert_array_equal(T.anchor_cost_matrix(96), J.anchor_cost_matrix(96))
    depth = np.random.default_rng(1).uniform(0.5, 2.0, 128).astype(np.float32)
    np.testing.assert_array_equal(T.geometric_cost_matrix(128, depth),
                                  J.geometric_cost_matrix(128, depth))
    ref = np.asarray(J.geometric_cost_matrix_jnp(jnp.asarray(depth)))
    got = T.geometric_cost_matrix_tensor(torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_identical_histograms_give_zero():
    x, _ = _dists(seed=3)
    v = T.SamplesLoss("sinkhorn", blur=0.025, diameter=2.0)(torch.from_numpy(x),
                                                            torch.from_numpy(x))
    np.testing.assert_allclose(v.numpy(), 0.0, atol=1e-4)


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError):
        T.SamplesLoss("sinkhorn", axis_name="data")
    with pytest.raises(ValueError, match="backend"):
        T.SamplesLoss("sinkhorn", backend="pallas")
