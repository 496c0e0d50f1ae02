"""The port's tensor-parallel training (emlight_tpu_torch/dist/auto.py:
make_auto_regression_step, make_auto_projector_steps; dist/mesh.py's
differentiable collectives; dist/fullsize_check.py's rank body) over a
(data, model) grid of 4 gloo ranks on the CPU, against the JAX package's
single-device steps at tests/test_auto.py's configs, seeds and bars, and
against the port's one-device fused step gradient by gradient.

One module fixture starts the 4 ranks once (tests/torch_dist_ranks.py, job
``auto_train``: a FileStore in tmp_path, one torch thread each, a
deadline). On the dp2 x tp2 and dp1 x tp4 grids they take a regression
step (test_auto's CFG, key 0, batch seed 1) and a fused G+D step
(TINY_PROJ, key 5, batch seed 7) from the JAX states' weights, carried
across by train/jax_weights.py; on dp2 x tp2 a G then a D step; then the
collectives' checks and fullsize_check's rank body at a small size. While
they run, this process computes JAX's R.train_step and P.fused_gan_step
on the whole batches and the port's one-device fused_gan_step.

The split leaves come back as each model rank's slice: the tests join
them by the channels each rank holds (a split conv's ``channels``, a
norm's contiguous slice) before comparing, so a gradient summed where it
belonged to one rank, or the reverse, shows as a leaf tp times off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu.train.data import synthetic_projector_batch, synthetic_regression_batch
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train.jax_weights import (
    densenet_state_from_jax,
    discriminator_state_from_jax,
    generator_state_from_jax,
)
from test_auto import CFG, TINY_PROJ
from test_torch_projector_train import GRAD_FLOOR, GRAD_REL, STATE_TOL
from torch_dist_ranks import start_ranks, wait_ranks
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    init0,
    jax_projector_state,
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
    port_regression_cfg,
)

GRIDS = {"dp2xtp2": (2, 2), "dp1xtp4": (1, 4)}
DEADLINE_S = 150
# fullsize_check's rank body at the test's size, on dp2 x tp2
FULLSIZE = dict(tp=2, batch=8, crop_size=64, ngf=8, anchors=16)
FULLSIZE_KEYS = {"mesh", "platform", "backend", "crop_size", "ngf", "batch", "init_s",
                 "first_step_s", "step_s", "loss_G", "loss_D", "peak_memory_gib",
                 "peak_memory_of"}
# a fused step's model collectives at ngf 8, every conv but the head split:
# forward all-gathers (each block's mlp_shared output and split conv
# inputs, the head's input), backward reduce-scatters (all of those but
# the head's, whose reader is whole) and the backward all-gather of
# head_0's input slice
FUSED_COLLECTIVES = (26, 25, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _proj_batch(seed):
    return synthetic_projector_batch(8, n_anchors=16, crop_size=32, env_hw=(32, 64), seed=seed)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    reg_cfg, gan_cfg = port_regression_cfg(CFG), port_projector_cfg(TINY_PROJ)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "run_init", init0)
        reg_state = R.create_state(jax.random.PRNGKey(0), CFG)
    proj_state = jax_projector_state(TINY_PROJ, 5)
    reg_batch = synthetic_regression_batch(8, 96, (32, 32), seed=1)
    gan_batch = _proj_batch(7)
    g_sd = generator_state_from_jax(_np(proj_state.g_params), _np(proj_state.g_stats))
    d_sd = discriminator_state_from_jax(_np(proj_state.d_params), _np(proj_state.d_stats))
    inp = dict(reg_cfg=reg_cfg, gan_cfg=gan_cfg, reg_batch=reg_batch, gan_batch=gan_batch,
               alt_batch=_proj_batch(0), g_sd=g_sd, d_sd=d_sd, fullsize=FULLSIZE,
               reg_sd=densenet_state_from_jax(_np(reg_state.params), _np(reg_state.batch_stats)))
    work = tmp_path_factory.mktemp("auto_train")
    procs = start_ranks(work, "auto_train", inp, world=4)
    try:
        # the references, while the ranks run
        ss, ms = R.train_step(reg_state, {k: jnp.asarray(v) for k, v in reg_batch.items()}, CFG)
        reg_ref = dict(loss=float(ms["loss"]),
                       state=densenet_state_from_jax(_np(ss.params), _np(ss.batch_stats)),
                       params=set(densenet_state_from_jax(_np(ss.params), {})))
        sp, mp, _ = P.fused_gan_step(proj_state, {k: jnp.asarray(v) for k, v in gan_batch.items()},
                                     TINY_PROJ)
        gan_ref = dict(loss_G=float(mp["loss_G"]), loss_D=float(mp["loss_D"]),
                       g_state=generator_state_from_jax(_np(sp.g_params), _np(sp.g_stats)))
        state = TP.create_state(gan_cfg, device="cpu")
        state.g.load_state_dict(g_sd, strict=True)
        state.d.load_state_dict(d_sd, strict=True)
        TP.fused_gan_step(state, gan_batch)
        port = dict(g_grads={n: p.grad for n, p in state.g.named_parameters()},
                    d_grads={n: p.grad for n, p in state.d.named_parameters()},
                    g_state=state.g.state_dict(), d_state=state.d.state_dict())
    finally:
        ranks = wait_ranks(work, procs, DEADLINE_S)
    return dict(ranks=ranks, reg=reg_ref, gan=gan_ref, port=port)


def _by_data_index(ranks, grid):
    """The ranks' outputs on the grid, grouped by data index, each group in
    model-rank order."""
    tp = GRIDS[grid][1]
    return [[r[grid] for r in ranks[d * tp:(d + 1) * tp]] for d in range(GRIDS[grid][0])]


def _join(group, leaves, name, ref, sliced=None):
    """One data index's model ranks' copies of a leaf as the whole leaf: a
    leaf of the whole's shape must be equal on every model rank; a split
    one is scattered to the channels each rank holds (``sliced``'s, else a
    contiguous slice)."""
    got = [leaves(o)[name] for o in group]
    if got[0].shape == ref.shape:
        for g in got[1:]:
            assert torch.equal(g, got[0]), f"{name} differs between model ranks"
        return got[0]
    full = torch.full(ref.shape, float("nan"))
    for o, g in zip(group, got):
        r, tp = o["model"]
        idx = (sliced(o) if sliced else {}).get(name)
        if idx is None:
            per = ref.shape[-1] // tp
            idx = torch.arange(r * per, (r + 1) * per)
        full[..., idx] = g
    assert not full.isnan().any(), name
    return full


def _grad_ratios(port: dict, ref: dict) -> dict:
    """Each leaf's max|port - ref| over its own largest magnitude, floored
    at GRAD_FLOOR of the tree's largest gradient."""
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:5]
    scale = max(r.abs().max().item() for r in ref.values())
    return {n: (port[n] - r).abs().max().item() / max(r.abs().max().item(), GRAD_FLOOR * scale)
            for n, r in ref.items()}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_auto_regression_step_matches_jax(run, grid):
    """The regression step on the grid against JAX's R.train_step on the
    whole batch at test_auto's bars: the loss (rtol 1e-4), the parameters
    after Adam (rtol 1e-3, atol 2e-6) and the BatchNorm statistics (rtol
    1e-4, atol 1e-6), on every rank; the regressor runs whole, so every
    leaf is equal on the model ranks of a data index."""
    ref = run["reg"]
    for group in _by_data_index(run["ranks"], grid):
        assert group[0]["reg"]["metrics"]["loss"].item() == pytest.approx(ref["loss"], rel=1e-4)
        for name, want in ref["state"].items():
            got = _join(group, lambda o: o["reg"]["state"], name, want)
            tol = dict(rtol=1e-3, atol=2e-6) if name in ref["params"] else dict(rtol=1e-4,
                                                                                  atol=1e-6)
            np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name, **tol)
        for o in group[1:]:
            assert o["reg"]["metrics"] == group[0]["reg"]["metrics"]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_auto_fused_step_losses_and_stats_match_jax(run, grid):
    """loss_G and loss_D against JAX's fused_gan_step on the whole batch
    (rtol 1e-4), equal on every model rank; G's BatchNorm running
    statistics, joined over the model ranks, at test_auto's bar (rtol 1e-4,
    atol 1e-6); the fake is the rank's data rows, whole channels."""
    ref = run["gan"]
    n = 0
    for group in _by_data_index(run["ranks"], grid):
        metrics = group[0]["fused"]["metrics"]
        for key in ("loss_G", "loss_D"):
            assert metrics[key].item() == pytest.approx(ref[key], rel=1e-4), key
        for o in group:
            assert o["fused"]["metrics"] == metrics
            assert o["fused"]["fake"].shape == (8 // GRIDS[grid][0], 32, 64, 3)
            assert o["fused"]["step"] == (1, 1)
        for name, want in ref["g_state"].items():
            if name.endswith((".mean", ".var")):
                got = _join(group, lambda o: o["fused"]["g_state"], name, want)
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=name)
                n += 1
    assert n == 18 * GRIDS[grid][0] * 2  # 18 SPADE norms, mean and var


@pytest.mark.parametrize("grid", list(GRIDS))
def test_auto_fused_step_every_gradient_matches_one_device(run, grid):
    """Every gradient leaf of G and D before Adam, the split ones joined
    over the model ranks, against the port's one-device fused_gan_step on
    the whole batch: each leaf within GRAD_REL of its own largest
    magnitude, floored at GRAD_FLOOR of the net's largest gradient
    (tests/test_torch_projector_train.py's bars). A sum over the model
    ranks where a slice belonged, or the reverse, moves a leaf by a factor
    of tp."""
    port = run["port"]
    for group in _by_data_index(run["ranks"], grid):
        for net in ("g", "d"):
            ref = port[f"{net}_grads"]
            got = {n: _join(group, lambda o: o["fused"][f"{net}_grads"], n, r,
                            lambda o: o["fused"]["sliced"]) for n, r in ref.items()}
            bad = {n: v for n, v in _grad_ratios(got, ref).items() if v > GRAD_REL}
            assert not bad, f"{net.upper()}: {len(bad)} leaves above {GRAD_REL}: {bad}"


@pytest.mark.parametrize("grid", list(GRIDS))
def test_auto_fused_step_spectral_state_matches_one_device(run, grid):
    """The spectral u (joined over the model ranks) and v that the power
    iteration on the split kernels stores, and D's, against the port's
    one-device fused step at the state bar (rtol 1e-4, atol 1e-5)."""
    port = run["port"]
    n = 0
    for group in _by_data_index(run["ranks"], grid):
        for net in ("g", "d"):
            for name, want in port[f"{net}_state"].items():
                if name.endswith((".u", ".v")):
                    got = _join(group, lambda o: o["fused"][f"{net}_state"], name, want,
                                lambda o: o["fused"]["sliced"] if net == "g" else {})
                    np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name,
                                               **STATE_TOL)
                    n += 1
    assert n > 0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_auto_fused_step_collectives_and_whole_leaves(run, grid):
    """Per rank, the fused step's model collectives (FUSED_COLLECTIVES); the
    whole parameters (encoder, head, D), averaged over the whole grid, are
    equal bit for bit on every rank after the Adam update."""
    ranks = [r[grid] for r in run["ranks"]]
    for o in ranks:
        assert o["fused"]["collectives"] == FUSED_COLLECTIVES
        assert o["fused"]["whole"].keys() == ranks[0]["fused"]["whole"].keys()
        for name, leaf in o["fused"]["whole"].items():
            assert torch.equal(leaf, ranks[0]["fused"]["whole"][name]), name
    assert any(name.startswith("0.netE.") for name in ranks[0]["fused"]["whole"])
    assert "0.sphere_conv1.kernel" in ranks[0]["fused"]["whole"]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_clip_norm_on_the_grid_is_one_devices(run, grid):
    """grads_global_norm over the model ranks (clip_by_global_norm's norm)
    on the placed G equals the norm of the joined gradients (rtol 1e-5),
    on every rank; clipping to half of it halves it."""
    port = run["port"]["g_grads"]
    for group in _by_data_index(run["ranks"], grid):
        joined = [_join(group, lambda o: o["fused"]["g_grads"], n, r,
                        lambda o: o["fused"]["sliced"]) for n, r in port.items()]
        want = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in joined])).item()
        for o in group:
            norm, clipped = (t.item() for t in o["norm"])
            assert norm == pytest.approx(want, rel=1e-5)
            assert clipped == pytest.approx(norm / 2, rel=1e-5)


def test_auto_alternating_steps_run_and_stay_finite(run):
    """A G step then a D step on dp2 x tp2 (seed 2, batch seed 0): finite
    metrics equal on the model ranks, the fake of the rank's rows, one
    generator step; the whole parameters equal bit for bit on every
    rank."""
    outs = [r["alternating"] for r in run["ranks"]]
    for rank, o in enumerate(outs):
        assert set(o["metrics"]) == {"GAN", "GAN_Feat", "COS", "loss_G", "D_Fake", "D_real",
                                     "loss_D"}
        assert all(np.isfinite(v.item()) for v in o["metrics"].values())
        assert o["metrics"] == outs[rank - rank % 2]["metrics"]
        assert o["fake_shape"] == (4, 32, 64, 3)
        assert o["step"] == 1
        for name, leaf in o["whole"].items():
            assert torch.equal(leaf, outs[0]["whole"][name]), name


@pytest.mark.parametrize("case", ["split_reader", "whole_reader", "split", "by_part"])
def test_differentiable_collectives(run, case):
    """all_gather_channels' backward sums the cotangent over the model ranks
    where split readers left it partial and slices it alone where the
    reader is whole (per part with ``parts=2``: part 0 summed, part 1
    sliced); split_channels' backward all-gathers it. On tp 4 (tp 2 for
    by_part), with each rank's weights (m + 1) x a ramp where the readers
    are split."""
    for rank, r in enumerate(run["ranks"]):
        o = r["gathers"][case]
        if case == "split":
            m = rank
            assert torch.equal(o["y"], torch.arange(16.0).reshape(2, 8)[:, 2 * m:2 * m + 2])
            assert torch.equal(o["grad"], torch.arange(1.0, 5.0).repeat_interleave(2).expand(2, 8))
            continue
        if case == "by_part":
            m = rank % 2
            x = [torch.arange(6.0) + 10 * i for i in range(2)]
            assert torch.equal(o["y"][0], torch.cat([x[0][:3], x[1][:3], x[0][3:], x[1][3:]]))
            ramp = torch.arange(12.0)
            want = torch.cat([3 * ramp[3 * m:3 * m + 3], ramp[6 + 3 * m:9 + 3 * m]])
            assert torch.equal(o["grad"][0], want)
            continue
        m = rank
        assert torch.equal(o["y"], torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * i
                                              for i in range(4)], -1))
        ramp = torch.arange(24.0).reshape(2, 12)[:, 3 * m:3 * m + 3]
        assert torch.equal(o["grad"], ramp * (10 if case == "split_reader" else 1))


def test_fullsize_check_rank_body(run):
    """fullsize_check's rank body on dp2 x tp2 at crop 64, ngf 8, 16
    anchors, batch 8: the JSON keys, finite losses equal on every rank."""
    outs = [r["fullsize"] for r in run["ranks"]]
    for o in outs:
        assert set(o) == FULLSIZE_KEYS
        assert (o["mesh"], o["platform"], o["backend"]) == ("dp2 x tp2", "cpu", "gloo")
        assert (o["crop_size"], o["ngf"], o["batch"]) == (64, 8, 8)
        assert np.isfinite(o["loss_G"]) and np.isfinite(o["loss_D"])
        assert (o["loss_G"], o["loss_D"]) == (outs[0]["loss_G"], outs[0]["loss_D"])
        assert min(o["init_s"], o["first_step_s"], o["step_s"], o["peak_memory_gib"]) > 0
    assert dataclasses.asdict(port_projector_cfg(TINY_PROJ))["use_vgg_loss"] is False
