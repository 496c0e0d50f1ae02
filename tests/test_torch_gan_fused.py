"""The port's fused G+D step and its scan (emlight_tpu_torch.train.projector:
fused_gan_step, scanned_fused_steps), with the VGG19 perceptual term on,
against the JAX package's fused_gan_step, at the TINY config of
tests/test_torch_projector_train.py (ngf 8, ndf 8, crop 64 -> 32x64 env
maps, 96 anchors, batch 2) and ``random_vgg19_params(0)``, the weights
carried across by the bridge.

One JAX program serves every comparison: fused_gan_step with an optax
transformation whose update is zero and whose state is the gradient
(torch_port_helpers.capture_tx), so each JAX gradient is read exactly. It
runs from the initial state on batch 1 (step 1), then on batch 2 (step 2),
and step 2 again on a batch whose images are jittered by JITTER relative.

- Step 1 against the port's fused_gan_step: the losses, every G and D
  gradient leaf, G's BatchNorm statistics and u, v, and D's u, v (moved
  once: the D pass inside G's loss throws its update away) under the bars
  of tests/test_torch_projector_train.py. The JAX package's own test shows
  that the fused G update is generator_step's
  (tests/test_projector_train.py::test_fused_step_matches_alternating_grads),
  so the port's generator_step with VGG is held to the same step.
- Steps 1 and 2 against the port's scanned_fused_steps at N = 2 with a zero
  learning rate (the parameters stay, as under the capture): the losses
  and step 2's gradients, each within the larger of the first-step bar and
  GRAD_SPREAD times the change the jittered batch makes to JAX's own step
  2 (tests/test_torch_train_state.py's measured bar), and the state both
  steps leave at the state bar.
- The port's scan against its own fused_gan_step iterated twice, with
  Adam: equal bit for bit. A VGG run's train state is the default tree
  (the VGG weights live outside it in both packages): the JAX package
  restores the port's file into its create_state template, bit for bit.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import vgg as jvgg
from emlight_tpu.train import checkpoint as jckpt
from emlight_tpu.train import projector as P
from emlight_tpu.train.data import synthetic_projector_batch
from emlight_tpu_torch.nn import vgg as tvgg
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train.checkpoint import save_train_state, train_state_tree
from emlight_tpu_torch.train.jax_weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)
from test_torch_projector_train import GRAD_FLOOR, GRAD_REL, LOSS_RTOL, STATE_TOL, TINY
from test_torch_train_state import GRAD_SPREAD, JITTER, _leaves
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    capture_tx,
    jax_projector_state,
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
)

STATS = (".mean", ".var", ".u", ".v")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed):
    return synthetic_projector_batch(2, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=seed)


def _jittered(batch, seed):
    rng = np.random.default_rng(seed)
    return {k: (v * (1 + JITTER * rng.standard_normal(v.shape))).astype(np.float32)
            if k in ("crop", "warped") else v for k, v in batch.items()}


def _port_state(s, lr=None):
    """A port train state holding the JAX state's weights and statistics;
    lr 0 makes each Adam update leave the parameters as they are."""
    state = TP.create_state(port_projector_cfg(TINY), device="cpu")
    state.g.load_state_dict(generator_state_from_jax(_np(s.g_params), _np(s.g_stats)),
                            strict=True)
    state.d.load_state_dict(discriminator_state_from_jax(_np(s.d_params), _np(s.d_stats)),
                            strict=True)
    if lr is not None:
        state.lr_g = state.lr_d = lambda step: lr
    return state


def _grads(state):
    return ({k: p.grad.clone() for k, p in state.g.named_parameters()},
            {k: p.grad.clone() for k, p in state.d.named_parameters()})


def _ref_grads(s):
    return (generator_state_from_jax(_np(s.g_opt), {}),
            discriminator_state_from_jax(_np(s.d_opt), {}))


def _ratios(port: dict, ref: dict) -> dict:
    """Each leaf's max|port - ref| over its own largest magnitude, floored
    at GRAD_FLOOR of the tree's largest gradient."""
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:5]
    scale = max(r.abs().max().item() for r in ref.values())
    return {n: (port[n] - r).abs().max().item() / max(r.abs().max().item(), GRAD_FLOOR * scale)
            for n, r in ref.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    s_adam = jax_projector_state(TINY)
    tx = capture_tx()
    s0 = s_adam.replace(tx_g=tx, tx_d=tx, g_opt=tx.init(s_adam.g_params),
                        d_opt=tx.init(s_adam.d_params))
    vgg_vars, vgg_apply = jvgg.random_vgg19_params(0), jvgg.VGG19Features().apply
    b1, b2 = _batch(41), _batch(42)

    def jstep(s, b):
        return P.fused_gan_step(s, {k: jnp.asarray(v) for k, v in b.items()}, TINY, vgg_apply,
                                vgg_vars)

    s1, m1, f1 = jstep(s0, b1)
    s2, m2, _ = jstep(s1, b2)
    s2j, m2j, _ = jstep(s1, _jittered(b2, 43))
    vgg = tvgg.VGG19Features(_np(vgg_vars), device="cpu")
    out = dict(s_adam=s_adam, s1=s1, s2=s2, s2j=s2j, vgg=vgg, b1=b1, b2=b2,
               jax_metrics=[{k: float(v) for k, v in m.items()} for m in (m1, m2, m2j)],
               jax_fake=np.asarray(f1))

    iterated = _port_state(s0)  # step 1, then step 2 below
    first = TP.fused_gan_step(iterated, b1, vgg)
    m, fake = first
    out["fused"] = dict(metrics={k: v.item() for k, v in m.items()}, fake=fake.numpy(),
                        grads=_grads(iterated), steps=(iterated.step, iterated.d_step),
                        g_sd={k: t.clone() for k, t in iterated.g.state_dict().items()},
                        d_sd={k: t.clone() for k, t in iterated.d.state_dict().items()})
    port = _port_state(s0)  # generator_step with VGG on batch 1
    m, _ = TP.generator_step(port, b1, vgg)
    out["g_step"] = dict(metrics={k: v.item() for k, v in m.items()},
                         grads={k: p.grad.clone() for k, p in port.g.named_parameters()})
    port = _port_state(s0, lr=0.0)  # the scan at a zero learning rate
    stacked = {k: np.stack([b1[k], b2[k]]) for k in b1}
    m, _ = TP.scanned_fused_steps(port, stacked, vgg)
    out["scan0"] = dict(metrics={k: v.numpy() for k, v in m.items()}, grads=_grads(port),
                        g_sd=dict(port.g.state_dict()), d_sd=dict(port.d.state_dict()))

    # with Adam: the scan and the iterated fused step, and the scan's file
    scanned = _port_state(s0)
    out["adam"] = [TP.scanned_fused_steps(scanned, stacked, vgg),
                   [first, TP.fused_gan_step(iterated, b2, vgg)]]
    out["states"] = scanned, iterated
    out["file"] = save_train_state(str(tmp_path_factory.mktemp("vgg_run")), scanned)
    return out


def test_fused_step_losses_and_fake(run):
    ref, got = run["jax_metrics"][0], run["fused"]["metrics"]
    assert set(got) == set(ref) == {"GAN", "GAN_Feat", "COS", "VGG", "loss_G", "D_Fake",
                                    "D_real", "loss_D"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(run["fused"]["fake"], run["jax_fake"], rtol=1e-4, atol=5e-4)
    assert run["fused"]["steps"] == (1, 1)


@pytest.mark.parametrize("net", ["G", "D"])
def test_fused_step_gradients_every_leaf(run, net):
    i = "GD".index(net)
    ratios = _ratios(run["fused"]["grads"][i], _ref_grads(run["s1"])[i])
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= GRAD_REL, (net, worst, ratios[worst])


@pytest.mark.parametrize("net", ["G", "D"])
def test_fused_step_state(run, net):
    """G's BatchNorm statistics and u, v moved once by its one forward; D's
    u, v moved once, by the D loss's pass (the JAX step keeps that pass's
    update and drops the one inside G's loss)."""
    s1 = run["s1"]
    ref = (generator_state_from_jax(_np(s1.g_params), _np(s1.g_stats)) if net == "G" else
           discriminator_state_from_jax(_np(s1.d_params), _np(s1.d_stats)))
    got = run["fused"]["g_sd" if net == "G" else "d_sd"]
    keys = [k for k in ref if k.endswith(STATS)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=k, **STATE_TOL)


def test_generator_step_with_vgg_is_the_fused_g_update(run):
    ref = run["jax_metrics"][0]
    got = run["g_step"]["metrics"]
    assert set(got) == {"GAN", "GAN_Feat", "COS", "VGG", "loss_G"}
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
    ratios = _ratios(run["g_step"]["grads"], _ref_grads(run["s1"])[0])
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= GRAD_REL, (worst, ratios[worst])


def test_scan_matches_jax_fused_steps_iterated(run):
    """Both steps' losses, step 2's every gradient leaf and the state after
    step 2; step 2 within the larger of the first-step bar and GRAD_SPREAD
    times JAX's own spread under the jittered batch."""
    m1, m2, m2j = run["jax_metrics"]
    got = run["scan0"]["metrics"]
    for i, ref in enumerate((m1, m2)):
        assert set(got) == set(ref)
        for k in ref:
            bar = LOSS_RTOL if i == 0 else max(
                LOSS_RTOL, GRAD_SPREAD * abs(m2j[k] - ref[k]) / abs(ref[k]))
            np.testing.assert_allclose(got[k][i], ref[k], rtol=bar, err_msg=f"{k}[{i}]")
    for i, net in enumerate("GD"):
        ref = _ref_grads(run["s2"])[i]
        spread = max(_ratios(_ref_grads(run["s2j"])[i], ref).values())
        bar = max(GRAD_REL, GRAD_SPREAD * spread)
        ratios = _ratios(run["scan0"]["grads"][i], ref)
        worst = max(ratios, key=ratios.get)
        assert ratios[worst] <= bar, (net, worst, ratios[worst], bar)
    s2 = run["s2"]
    for sd, ref in ((run["scan0"]["g_sd"], generator_state_from_jax(_np(s2.g_params),
                                                                    _np(s2.g_stats))),
                    (run["scan0"]["d_sd"], discriminator_state_from_jax(_np(s2.d_params),
                                                                        _np(s2.d_stats)))):
        for k in ref:
            if k.endswith(STATS):
                np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), err_msg=k,
                                           **STATE_TOL)
            else:  # the zero learning rate left every parameter as it was
                assert torch.equal(sd[k], ref[k]), k


def test_scan_equals_the_ports_iterated_fused_steps(run):
    (m_scan, fake_scan), steps = run["adam"]
    for i, (m, _) in enumerate(steps):
        assert set(m) == set(m_scan)
        for k in m:
            assert torch.equal(m_scan[k][i], m[k]), (k, i)
    assert torch.equal(fake_scan, steps[-1][1])
    scanned, iterated = run["states"]
    assert (scanned.step, scanned.d_step) == (iterated.step, iterated.d_step) == (2, 2)
    a, b = train_state_tree(scanned), train_state_tree(iterated)
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y), "/".join(path)


def test_vgg_run_state_is_the_default_tree(run):
    restored = jckpt.restore_checkpoint(run["file"], run["s_adam"])
    got = dict(_leaves(jax.tree.map(np.asarray, flax.serialization.to_state_dict(restored))))
    mine = dict(_leaves(train_state_tree(run["states"][0])))
    assert set(got) == set(mine)
    for k, a in got.items():
        assert a.dtype == mine[k].dtype and np.array_equal(a, mine[k]), "/".join(k)
    assert int(restored.step) == 2
