"""Full train-state checkpoints between the packages (emlight_tpu_torch.train
.checkpoint: save_train_state, restore_train_state, latest_checkpoint),
for a RegressionState and a ProjectorState, with and without
--clip_grad_norm (another optax state structure).

JAX to the port: the JAX package takes 2 steps and saves; the port restores
that file into its own train state and takes 1 step on the batch of JAX's
third step (the GAN's G step, then its D step from JAX's state after that
G step, as tests/test_torch_projector_train.py does). The two states after
each step are compared leaf by leaf: the losses at LOSS_RTOL, BatchNorm
statistics and spectral u, v at STATE_TOL, the counts and steps exactly,
and Adam's moments at the gradient bars of tests/test_torch_{regression,
projector}_train.py (each leaf within GRAD_REL of its own largest
magnitude, floored at GRAD_FLOOR of the tree's largest), or, where larger,
within GRAD_SPREAD times the largest change the JAX step itself makes to
that optimizer's moments when its batch's images are jittered by JITTER
relative. The spread is measured because after two steps the GAN's
gradients are ill-conditioned in f32: the JAX package's own G gradient
differs by 1.6e-2 of the leaf (netE.layer3) between XLA optimization
levels 0 and 3 at the PRNGKey(1) state and seed-23 batch (level 0 against
the port: 1.6e-2), where the state and batch of
tests/test_torch_projector_train.py stay within 3e-5. This is chip_smoke.py
phase 9's bar. Parameters: each side's update must be optax's Adam
arithmetic on its own moments (p - lr * mu_hat / (sqrt(nu_hat) + eps), at
f32 rounding), and the two sides' parameters lie within the most two Adam
steps of opposite sign can differ (2 lr times the largest |mu_hat| /
sqrt(nu_hat) the count allows): where a leaf's gradient is rounding noise
(a conv bias before a batch norm; measured 3.05 lr at G_middle_0's conv
bias after the G step) one side's step can be the other's negated.

The port to JAX: the port takes 2 steps from the JAX package's initial
state and saves; the JAX package's restore_checkpoint into its
create_state template accepts the file and restores every leaf bit for bit,
and the port's file read back equals its state bit for bit.

Small configs: tests/test_torch_regression_train.py's SMALL (crop 64x64,
blocks (2, 2), batch 2) and tests/test_torch_projector_train.py's TINY
(ngf 8, ndf 8, crop 64, batch 2), 96 anchors."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.config import AnchorConfig, ProjectorConfig, RegressionConfig
from emlight_tpu.train import checkpoint as jckpt
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu.train.data import synthetic_projector_batch, synthetic_regression_batch
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    read_checkpoint,
    restore_train_state,
    save_train_state,
    train_state_tree,
)
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    jax_states,
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
    port_regression_cfg,
)

SMALL = dataclasses.replace(RegressionConfig(), crop_h=64, crop_w=64, batch_size=2,
                            block_config=(2, 2))
TINY = dataclasses.replace(ProjectorConfig(), crop_size=64, ngf=8, ndf=8, batch_size=2,
                           anchors=AnchorConfig(n_anchors=96, env_h=32, env_w=64))
CLIPS = [0.0, 1.0]

# the bars of tests/test_torch_regression_train.py and
# tests/test_torch_projector_train.py
BARS = {
    "regression": dict(loss_rtol=1e-4, state=dict(rtol=2e-5, atol=1e-6), grad_rel=2e-4,
                       grad_floor=1e-2),
    "projector": dict(loss_rtol=1e-4, state=dict(rtol=1e-4, atol=1e-5), grad_rel=2e-4,
                      grad_floor=1e-3),
}
# the measured moment bar (chip_smoke.py phase 9's constants)
GRAD_SPREAD, JITTER = 4.0, 1e-6


def adam_bound(b1: float, b2: float, t: int) -> float:
    """The largest |mu_hat| / sqrt(nu_hat) optax.adam's count t allows
    (Cauchy-Schwarz over the t gradients' weights in mu and nu)."""
    a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    b = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return float(np.sqrt(sum(x * x / y for x, y in zip(a, b))))


def _batches(kind):
    if kind == "regression":
        return [synthetic_regression_batch(2, 96, (64, 64), seed=s) for s in (11, 12, 13)]
    return [synthetic_projector_batch(2, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=s)
            for s in (21, 22, 23)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _jittered(batch, seed):
    """The batch with its images moved by JITTER relative."""
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray((v * (1 + JITTER * rng.standard_normal(v.shape))).astype(np.float32)
                           if k in ("crop", "warped") else v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=CLIPS, ids=["noclip", "clip"])
def run(request, tmp_path_factory):
    """Per clip setting: the JAX states, JAX's 2 + 1 steps of each kind, the
    port's step after restoring JAX's file, and the port's own 2 steps and
    file. Returns everything the tests compare."""
    clip = request.param
    reg_cfg = dataclasses.replace(SMALL, clip_grad_norm=clip)
    proj_cfg = dataclasses.replace(TINY, clip_grad_norm=clip)
    reg0, proj0 = jax_states(reg_cfg, proj_cfg)
    d = tmp_path_factory.mktemp(f"state_clip{clip}")
    out = {"clip": clip, "dir": d, "jax0": {"regression": reg0, "projector": proj0},
           "cfg": {"regression": reg_cfg, "projector": proj_cfg}}

    # regression: JAX 2 steps, save, step 3; the port restores and steps
    b = _batches("regression")
    s = reg0
    for batch in b[:2]:
        s, _ = R.train_step(s, {k: jnp.asarray(v) for k, v in batch.items()}, reg_cfg)
    reg_file = jckpt.save_checkpoint(str(d / "jax_reg"), s)
    s3, m3 = R.train_step(s, {k: jnp.asarray(v) for k, v in b[2].items()}, reg_cfg)
    spread = _jax_tree(R.train_step(s, _jittered(b[2], 31), reg_cfg)[0])
    port = TR.create_state(port_regression_cfg(reg_cfg), device="cpu")
    restore_train_state(reg_file, port)
    restored_step = port.step
    m = TR.train_step(port, b[2])
    out["regression"] = dict(file=reg_file, restored_step=restored_step, jax=_jax_tree(s3),
                             jittered=spread,
                             port=train_state_tree(port),
                             losses=({k: float(v) for k, v in m3.items()},
                                     {k: v.item() for k, v in m.items()}))

    # projector: JAX 2 G+D iterations, save, iteration 3's G step, save, its
    # D step. The port restores the first file and takes the G step, then
    # the second and takes the D step (so each step starts from the state
    # JAX's did, as in tests/test_torch_projector_train.py)
    b = _batches("projector")
    s = proj0
    for batch in b[:2]:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        s, _, _ = P.generator_step(s, jb, proj_cfg)
        s, _ = P.discriminator_step(s, jb, proj_cfg)
    proj_file = jckpt.save_checkpoint(str(d / "jax_proj"), s)
    jb = {k: jnp.asarray(v) for k, v in b[2].items()}
    s_g, g3, _ = P.generator_step(s, jb, proj_cfg)
    after_g = jckpt.save_checkpoint(str(d / "jax_proj"), s_g, "after_g")
    s_d, d3 = P.discriminator_step(s_g, jb, proj_cfg)
    spread_g = _jax_tree(P.generator_step(s, _jittered(b[2], 32), proj_cfg)[0])
    spread_d = _jax_tree(P.discriminator_step(s_g, _jittered(b[2], 33), proj_cfg)[0])
    port = TP.create_state(port_projector_cfg(proj_cfg), device="cpu")
    restore_train_state(proj_file, port)
    restored_steps = (port.step, port.d_step)
    g, _ = TP.generator_step(port, b[2])
    out["projector_g"] = dict(file=proj_file, restored_step=restored_steps, jax=_jax_tree(s_g),
                              jittered=spread_g,
                              port=train_state_tree(port),
                              losses=({k: float(v) for k, v in g3.items()},
                                      {k: v.item() for k, v in g.items()}))
    restore_train_state(after_g, port)
    restored_steps = (port.step, port.d_step)
    dl = TP.discriminator_step(port, b[2])
    out["projector_d"] = dict(file=after_g, restored_step=restored_steps, jax=_jax_tree(s_d),
                              jittered=spread_d,
                              port=train_state_tree(port),
                              losses=({k: float(v) for k, v in d3.items()},
                                      {k: v.item() for k, v in dl.items()}))

    # the port's own 2 steps from the JAX package's initial state, saved
    for kind, state in (
            ("regression", TR.create_state(port_regression_cfg(reg_cfg), device="cpu")),
            ("projector", TP.create_state(port_projector_cfg(proj_cfg), device="cpu"))):
        init = jckpt.save_checkpoint(str(d / f"init_{kind}"), out["jax0"][kind])
        restore_train_state(init, state)
        for batch in _batches(kind)[:2]:
            if kind == "regression":
                TR.train_step(state, batch)
            else:
                TP.generator_step(state, batch)
                TP.discriminator_step(state, batch)
        out[f"port_{kind}"] = (save_train_state(str(d / f"port_{kind}" / "checkpoints"), state),
                               train_state_tree(state))
    return out


STEPS = ["regression", "projector_g", "projector_d"]


@pytest.mark.parametrize("kind", STEPS)
def test_step_after_a_jax_checkpoint_matches_jax(run, kind):
    r, bars = run[kind], BARS[kind.split("_")[0]]
    ref, got = r["losses"]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=bars["loss_rtol"], err_msg=k)
    assert r["restored_step"] == {"regression": 2, "projector_g": (2, 2),
                                  "projector_d": (3, 2)}[kind]


@pytest.mark.parametrize("kind", STEPS)
def test_state_after_a_jax_checkpoint_matches_jax(run, kind):
    """Every leaf of the two states after the step: steps and counts
    exactly, moments at the gradient bars, BatchNorm statistics and spectral
    vectors at the state bar, parameters within PARAM_ATOL_LR * lr."""
    r, bars = run[kind], BARS[kind.split("_")[0]]
    ref, got = dict(_leaves(r["jax"])), dict(_leaves(r["port"]))
    jit = dict(_leaves(r["jittered"]))
    assert set(ref) == set(got), sorted(set(ref) ^ set(got))[:5]

    def moments_of(path):  # the optimizer's mu or nu tree the leaf is in
        for m in ("mu", "nu"):
            if m in path:
                return path[:path.index(m) + 1]
        return None

    scale, ratios = {}, {}  # each tree's largest |moment|; (error / bar scale)
    for path, a in ref.items():
        if moments_of(path):
            scale[moments_of(path)] = max(scale.get(moments_of(path), 0.0),
                                          float(np.abs(a).max()))
    for path, a in ref.items():
        key = moments_of(path)
        if key:
            floor = max(np.abs(a).max(), bars["grad_floor"] * scale[key])
            spread = np.abs(jit[path] - a).max() / floor
            ratios[path] = np.abs(got[path] - a).max() / floor
            scale[key, "bar"] = max(scale.get((key, "bar"), bars["grad_rel"]),
                                    GRAD_SPREAD * spread)
    # per parameter tree: (optimizer tree, lr, b1, b2)
    opt = {"params": ("opt_state", SMALL.lr, *SMALL.betas),
           "g_params": ("g_opt", TINY.lr / 2, TINY.beta1, TINY.beta2),
           "d_params": ("d_opt", TINY.lr * 2, TINY.beta1, TINY.beta2)}
    adam_of = {}  # (optimizer tree, the parameter's path in its tree) -> its mu path
    for path in ref:
        if moments_of(path) and path[len(moments_of(path)) - 1] == "mu":
            adam_of[path[0], path[len(moments_of(path)):]] = path
    before = dict(_leaves(read_checkpoint(r["file"])))
    n = dict.fromkeys(("exact", "moment", "state", "param"), 0)
    for path, a in ref.items():
        b, where = got[path], "/".join(path)
        assert b.shape == a.shape and b.dtype == a.dtype, where
        if path[-1] in ("count", "step"):
            np.testing.assert_array_equal(b, a, err_msg=where)
            n["exact"] += 1
        elif moments_of(path):
            bar = scale[moments_of(path), "bar"]
            assert ratios[path] <= bar, (where, ratios[path], bar)
            n["moment"] += 1
        elif path[-1] in ("mean", "var", "u", "v"):
            np.testing.assert_allclose(b, a, err_msg=where, **bars["state"])
            n["state"] += 1
        else:
            tree, lr, b1, b2 = opt[path[0]]
            mu = adam_of[tree, path[1:]]
            nu = mu[:-len(path[1:]) - 1] + ("nu",) + path[1:]
            t = int(ref[mu[:-len(path[1:]) - 1] + ("count",)])
            if t == int(before[mu[:-len(path[1:]) - 1] + ("count",)]):  # not this step's
                assert np.array_equal(a, before[path]) and np.array_equal(b, a), where
                n["param"] += 1
                continue
            for side in (ref, got):  # each side's step is Adam on its own moments
                step = -lr * (side[mu] / (1 - b1 ** t)) / (
                    np.sqrt(side[nu] / (1 - b2 ** t)) + 1e-8)
                np.testing.assert_allclose(side[path], before[path] + step, rtol=1e-6,
                                           atol=1e-4 * lr, err_msg=where)
            bar = 2 * lr * adam_bound(b1, b2, t) * (1 + 1e-5)
            assert np.abs(b - a).max() <= bar, (where, np.abs(b - a).max(), bar)
            n["param"] += 1
    assert all(n.values()), n


@pytest.mark.parametrize("kind", ["regression", "projector"])
def test_jax_restores_the_ports_file_bit_for_bit(run, kind):
    """JAX's restore_checkpoint(path, create_state template) accepts the
    port's file; every leaf equals the port's state; the file read back
    equals it too."""
    path, tree = run[f"port_{kind}"]
    restored = jckpt.restore_checkpoint(path, run["jax0"][kind])
    jtree = _jax_tree(restored)
    mine = dict(_leaves(tree))
    assert set(dict(_leaves(jtree))) == set(mine)
    for p_, a in _leaves(jtree):
        assert a.dtype == mine[p_].dtype and np.array_equal(a, mine[p_]), "/".join(p_)
    for p_, a in _leaves(read_checkpoint(path)):
        assert a.dtype == mine[p_].dtype and np.array_equal(a, mine[p_]), "/".join(p_)
    assert int(restored.step) == 2
    assert latest_checkpoint(str(run["dir"] / f"port_{kind}" / "checkpoints")) == path
    assert latest_checkpoint(str(run["dir"] / "nowhere")) is None


@pytest.mark.parametrize("kind", ["regression", "projector"])
def test_a_clip_setting_other_than_the_files_raises(run, kind):
    other = 0.0 if run["clip"] else 1.0
    cfg = dataclasses.replace(run["cfg"][kind], clip_grad_norm=other)
    state = (TR.create_state(port_regression_cfg(cfg), device="cpu") if kind == "regression"
             else TP.create_state(port_projector_cfg(cfg), device="cpu"))
    path = run["regression" if kind == "regression" else "projector_g"]["file"]
    with pytest.raises(ValueError, match="--clip_grad_norm"):
        restore_train_state(path, state)


def test_a_shape_mismatch_names_the_entry(run):
    cfg = dataclasses.replace(run["cfg"]["regression"],
                              anchors=AnchorConfig(regression_anchors=48))
    state = TR.create_state(port_regression_cfg(cfg), device="cpu")
    with pytest.raises(ValueError, match=r"fc_dist\.weight.*\(48, .*\(96, "):
        restore_train_state(run["regression"]["file"], state)


def test_a_fresh_optimizer_round_trips(run, tmp_path):
    """A state that took no step saves count 0 and zero moments, and loads
    back as a fresh optimizer (no Adam state)."""
    cfg = port_regression_cfg(run["cfg"]["regression"])
    path = save_train_state(str(tmp_path), TR.create_state(cfg, device="cpu"))
    adam = read_checkpoint(path)["opt_state"]
    adam = adam["1"]["0"] if run["clip"] else adam["0"]
    assert int(adam["count"]) == 0
    assert not any(a.any() for _, a in _leaves({"mu": adam["mu"], "nu": adam["nu"]}))
    state = TR.create_state(cfg, device="cpu", seed=3)
    restore_train_state(path, state)
    assert len(state.opt.state) == 0 and state.step == 0
    torch.testing.assert_close(dict(state.model.state_dict()),
                               dict(TR.create_state(cfg, device="cpu").model.state_dict()))
