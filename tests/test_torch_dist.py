"""The port's data-parallel layer (emlight_tpu_torch.dist, BatchNorm and the
Sinkhorn loss over a group, the parallel train steps and serving) on two
gloo ranks on the CPU, against one device on the global batch.

The G, D and fused steps on two ranks are held to the JAX package's
steps in tests/test_torch_gan_fused.py, beside the JAX step they share.
One module fixture here starts the two ranks once (tests/torch_dist_ranks.py:
subprocesses with torchrun's environment, a FileStore in tmp_path, one
torch thread each, a deadline) and every test asserts on what they saved.
No JAX collective runs across devices: the JAX package's values come from
one device on the global batch, and its parallel regression gradient from
``jax.vmap(..., axis_name=...)`` (as tests/test_densenet_fast.py does).
While the ranks run, this process computes the references:

- the regression step in float64 at tests/test_dist.py's config (crop
  32x32, blocks (2,), 6 Sinkhorn iterations, a global batch of 4; the
  port's seeded weights carried to JAX by the bridge): JAX's
  ``jax.grad(loss_fn)`` on one device through its default (buffer) train
  forward, which both of the port's forwards are held to, in one jit at
  XLA level 0 with the vmapped parallel buffer route;
- BatchNorm on the concatenated batch, the Sinkhorn divergence of the
  whole batch, and the serving functions' single-device outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit0
from emlight_tpu.config import RegressionConfig, SinkhornConfig
from emlight_tpu.dist.mesh import pad_leading as jpad_leading
from emlight_tpu.train import regression as R
from emlight_tpu.train.data import synthetic_projector_batch, synthetic_regression_batch
from emlight_tpu_torch.dist.mesh import RankGroup, pad_leading
from emlight_tpu_torch.dist.parallel import serving_rows
from emlight_tpu_torch.losses.sinkhorn import SamplesLoss
from emlight_tpu_torch.nn.densenet import DenseNet
from emlight_tpu_torch.nn.layers import BatchNorm
from emlight_tpu_torch.nn.spade import SPADE
from emlight_tpu_torch.train import pipeline as TPL
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.jax_weights import densenet_tree_from_state
from test_torch_projector_train import GRAD_FLOOR, TINY
from torch_dist_ranks import start_ranks, wait_ranks
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
    port_regression_cfg,
)

CFG = dataclasses.replace(RegressionConfig(), crop_h=32, crop_w=32, batch_size=4,
                          block_config=(2,), sinkhorn=SinkhornConfig(n_iters=6))
F64_REL = 1e-10  # the f64 gradient bar, of each leaf's largest (floor: GRAD_FLOOR of the model's)
FAULT_REL = 1e-2  # the JAX buffer route's parallel gradient sits farther than this
DEADLINE_S = 150


def _x64():
    from jax._src.config import enable_x64  # as tests/test_densenet_fast.py does

    return enable_x64(True)


F64 = dataclasses.replace(CFG, dtype="float64")


def _port_regressor():
    """The regressor at CFG in float64, its weights drawn from a seeded
    torch.Generator: (state_dict, JAX params, JAX batch_stats)."""
    model = DenseNet(block_config=CFG.block_config, n_anchors=96, input_hw=(32, 32),
                     dtype=torch.float64, generator=torch.Generator().manual_seed(5)).double()
    sd = model.state_dict()
    params, stats = densenet_tree_from_state(sd)
    return sd, params, stats


def _jax_regression(params, stats, batch):
    """JAX's f64 loss, new statistics and gradient of loss_fn on one device
    (the default buffer forward) and the gradient under vmap(axis_name)
    over two halves of the batch, pmean'd, in one jit; NumPy trees."""
    cfg = F64
    with _x64():
        apply_fn = R.make_train_apply(cfg)
        par_apply = R.make_train_apply(cfg, axis_name="data")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        halves = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:]) for k, v in jb.items()}

        def single(p):
            fn = lambda q: R.loss_fn(q, stats, apply_fn, jb, cfg, True)  # noqa: E731
            (loss, (_, new, _)), g = jax.value_and_grad(fn, has_aux=True)(p)
            return loss, new, g

        def parallel(p, half):
            g = jax.grad(lambda q: R.loss_fn(q, stats, par_apply, half, cfg, True, "data")[0])(p)
            return jax.lax.pmean(g, "data")

        def every(p):
            vmapped = jax.vmap(parallel, in_axes=(None, 0), axis_name="data")(p, halves)
            return single(p), jax.tree.map(lambda a: a[0], vmapped)

        return jax.tree.map(np.asarray, jit0(every)(params))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    reg_batch = synthetic_regression_batch(4, 96, (32, 32), seed=1)
    reg_cfg = port_regression_cfg(CFG)
    gan_cfg = port_projector_cfg(TINY)
    # the Sinkhorn pair: peaked rows on rank 0, near-uniform ones on rank 1
    sx = np.concatenate([rng.gamma(0.05, 1.0, (2, 96)), 1 + 0.1 * rng.random((2, 96))])
    sy = np.concatenate([rng.gamma(0.3, 1.0, (2, 96)), 1 + 0.1 * rng.random((2, 96))])
    serve = synthetic_projector_batch(3, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=7)
    inp = dict(
        x=torch.from_numpy(rng.standard_normal((4, 3, 5, 6))),
        w=torch.from_numpy(rng.standard_normal((4, 3, 5, 6))),
        bn={"mean": torch.zeros(6, dtype=torch.float64) + 0.3,
            "var": torch.ones(6, dtype=torch.float64) * 0.7,
            "weight": torch.from_numpy(rng.uniform(0.5, 1.5, 6)),
            "bias": torch.from_numpy(rng.normal(0, 0.2, 6))},
        sx=torch.from_numpy(sx / sx.sum(1, keepdims=True)),
        sy=torch.from_numpy(sy / sy.sum(1, keepdims=True)),
        reg_cfg=reg_cfg, reg_batch=reg_batch, gan_cfg=gan_cfg,
        crop_reg=rng.random((3, 32, 32, 3), dtype=np.float32), crop_proj=serve["crop"],
        gan_serve={k: torch.from_numpy(v) for k, v in serve.items()},
    )
    inp["reg_sd"], params, stats = _port_regressor()
    work = tmp_path_factory.mktemp("dist")
    procs = start_ranks(work, "checks", inp)
    try:
        # the references, while the ranks run
        ref, par = _jax_regression(params, stats, reg_batch)
        bn = BatchNorm(6, affine=True).double().train()
        bn.load_state_dict(inp["bn"])
        x = inp["x"].clone().requires_grad_(True)
        y = bn(x)
        (y * inp["w"]).sum().backward()
        single = dict(
            bn=dict(y=y.detach(), x_grad=x.grad, state=bn.state_dict(),
                    p_grad={n: p.grad for n, p in bn.named_parameters()}),
            sinkhorn=SamplesLoss("sinkhorn", blur=0.025, n_iters=3)(inp["sx"], inp["sy"]))
        reg = TR.make_model(reg_cfg, device="cpu", seed=3)
        gen = TP.make_models(gan_cfg, device="cpu", seed=4)
        single["serving"] = dict(
            predict=TR.predict(reg, torch.from_numpy(inp["crop_reg"]),
                               TR.make_eval_apply(reg_cfg)),
            inference=TP.inference(gen, inp["gan_serve"], gan_cfg),
            pipeline=TPL.pipeline_inference(reg, gen, inp["crop_reg"], inp["crop_proj"], reg_cfg,
                                            gan_cfg, device="cpu"))
    finally:
        ranks = wait_ranks(work, procs, DEADLINE_S)
    return dict(inp=inp, ranks=ranks, single=single, jax=ref, jax_parallel=par)


def _rows(n, rank):
    return slice(rank * n // 2, (rank + 1) * n // 2)


def test_batchnorm_over_the_group_is_one_batchnorm_on_the_whole_batch(run):
    """Outputs and the input's gradient row for row, running statistics
    equal on both ranks, the parameter gradients' rank parts summing to the
    whole batch's (float64)."""
    ref = run["single"]["bn"]
    for r, got in enumerate(run["ranks"]):
        got = got["bn"]
        torch.testing.assert_close(got["y"], ref["y"][_rows(4, r)], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["x_grad"], ref["x_grad"][_rows(4, r)], rtol=1e-11,
                                   atol=1e-12)
        for k, v in ref["state"].items():
            torch.testing.assert_close(got["state"][k], v, rtol=1e-12, atol=1e-12, msg=k)
    for n, g in ref["p_grad"].items():
        summed = sum(rk["bn"]["p_grad"][n] for rk in run["ranks"])
        torch.testing.assert_close(summed, g, rtol=1e-12, atol=1e-12, msg=n)


def test_spade_batch_norm_stays_local():
    """Only "syncbatch" SPADE norms take the group; "batch" keeps each
    rank's own moments (emlight_tpu/nn/spade.py:109)."""
    group = RankGroup(pg=None, rank=0, size=2)
    assert SPADE(8, "syncbatch", 16, group=group).param_free_norm.group is group
    assert SPADE(8, "batch", 16, group=group).param_free_norm.group is None
    assert SPADE(8, "instance", 16, group=group).param_free_norm is None


def test_use_vae_noise_is_the_global_draw_sliced():
    """use_vae's latent noise under a group of 2: each rank's rows of the
    draw one device makes for the global batch (no collective: the seed
    is the step's)."""
    cfg = dataclasses.replace(port_projector_cfg(TINY), use_vae=True)
    single = TP.create_state(cfg, device="cpu")
    single.step = 3
    ref = TP.vae_noise(single, TP.VAE_G_SEED, 4)
    for rank in range(2):
        single.group = RankGroup(pg=None, rank=rank, size=2)
        assert torch.equal(TP.vae_noise(single, TP.VAE_G_SEED, 2), ref[2 * rank:2 * rank + 2])


def test_sinkhorn_diameter_is_the_global_batch(run):
    """Each rank's divergences (3 iterations, float64) equal the whole
    batch's rows to 1e-12: the ε schedule read the global min and max.
    Rank 1's near-uniform rows alone span less, and their schedule moves
    the divergences by more than 1e-10."""
    ref = run["single"]["sinkhorn"]
    for r, got in enumerate(run["ranks"]):
        torch.testing.assert_close(got["sinkhorn"], ref[_rows(4, r)], rtol=1e-12, atol=0)
    own = SamplesLoss("sinkhorn", blur=0.025, n_iters=3)(run["inp"]["sx"][2:],
                                                         run["inp"]["sy"][2:])
    assert ((own - ref[2:]).abs() / ref[2:].abs()).max() > 1e-10


def _leaf_errors(port_grads, ref_tree):
    got, _ = densenet_tree_from_state(port_grads)
    leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert jax.tree.structure(got) == jax.tree.structure(ref_tree)
    gmax = max(np.abs(b).max() for _, b in leaves)
    return {jax.tree_util.keystr(p): np.abs(a - b).max() / max(np.abs(b).max(), GRAD_FLOOR * gmax)
            for (p, b), a in zip(leaves, jax.tree.leaves(got))}


@pytest.mark.parametrize("route", ["buffer", "standard"])
def test_regression_gradient_is_the_global_batchs(run, route):
    """float64, two ranks of 2 rows through either forward against JAX's
    jax.grad(loss_fn) on one device and the batch of 4: every leaf within 1e-10 of its largest
    element (floored at GRAD_FLOOR of the model's largest); the running
    statistics at 1e-10, the averaged loss at 1e-8 (its target-only
    Sinkhorn terms run in the targets' float32 in both packages and carry
    no gradient); both ranks hold the same gradients and statistics."""
    loss, new_stats, grads = run["jax"]
    r0, r1 = (rk["regression"][route] for rk in run["ranks"])
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n
    errs = _leaf_errors(r0["grads"], grads)
    assert max(errs.values()) < F64_REL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    np.testing.assert_allclose(r0["metrics"]["loss"].item(), float(loss), rtol=1e-8)
    _, got_stats = densenet_tree_from_state(r0["state"])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got_stats)[0],
                            jax.tree.leaves(new_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12, err_msg=str(path))
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k


def test_jax_buffer_route_parallel_gradient_is_not_the_global_batchs(run):
    """A note on the reference (ROADMAP.md §3): the JAX package's buffer
    route under an axis name scales N by the axis size but never sums the
    moment cotangents over the devices, so its parallel gradient (vmap
    over two halves, pmean'd) misses the global batch's by more than 1e-2
    of a leaf's largest element, while the port's two ranks match it to
    1e-10."""
    _, _, grads = run["jax"]
    errs = {}
    for (p, b), a in zip(jax.tree_util.tree_flatten_with_path(grads)[0],
                         jax.tree.leaves(run["jax_parallel"])):
        errs[jax.tree_util.keystr(p)] = np.abs(a - b).max() / np.abs(b).max()
    assert max(errs.values()) > FAULT_REL, errs
    port = _leaf_errors(run["ranks"][0]["regression"]["buffer"]["grads"], grads)
    assert max(port.values()) < F64_REL


@pytest.mark.parametrize("fn", ["predict", "inference", "pipeline"])
def test_serving_ranks_cover_a_ragged_batch(run, fn):
    """A batch of 3 on two ranks: padded to 4 with the last row, rank 0
    serves rows 0-1, rank 1 row 2 (its padded copy dropped); each output
    equals the single-device run's row at the pipeline's bars."""
    served = []
    ref = run["single"]["serving"][fn]
    for rank in run["ranks"]:
        rows, *outs = rank["serving"][fn]
        served += list(rows)
        if fn == "predict":
            outs, ref_outs = [outs[0][k] for k in ref], [ref[k] for k in ref]
        elif fn == "inference":
            ref_outs = [ref]
        else:
            outs = [outs[0], *[outs[1][k] for k in ref[1]]]
            ref_outs = [ref[0], *[ref[1][k] for k in ref[1]]]
        for o, r in zip(outs, ref_outs):
            torch.testing.assert_close(o, r[torch.as_tensor(rows)], rtol=1e-4, atol=5e-4)
    assert served == [0, 1, 2]


def test_pad_leading_matches_jax():
    """Edge-repeat padding to a multiple (a dict of arrays, a list, a
    tensor), as emlight_tpu/dist/mesh.py::pad_leading; serving_rows splits
    the padded rows."""
    tree = {"a": np.arange(10.0).reshape(5, 2), "b": np.arange(5)}
    for multiple in (1, 2, 3, 4, 8):
        got, n = pad_leading(tree, multiple)
        ref, n_ref = jpad_leading(tree, multiple)
        assert n == n_ref == 5
        for k in tree:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    names, _ = pad_leading(["x", "y", "z"], 2)
    assert names == ["x", "y", "z", "z"]
    t, _ = pad_leading(torch.arange(3), 4)
    assert t.tolist() == [0, 1, 2, 2]
    for rank, want in ((0, ([0, 1], 2)), (1, ([2, 2], 1))):
        rows, n_real = serving_rows(3, RankGroup(pg=None, rank=rank, size=2))
        assert (rows.tolist(), n_real) == want
    assert serving_rows(3, RankGroup(pg=None, rank=3, size=4))[1] == 0
