"""The port's tensor-parallel serving (emlight_tpu_torch/dist/auto.py) over a
(data, model) grid of 4 gloo ranks on the CPU, against the port on one
device and the JAX package's single-device functions, at
tests/test_auto.py's configs and bars.

One module fixture starts the 4 ranks once (tests/torch_dist_ranks.py, job
``auto``: a FileStore in tmp_path, one torch thread each, a deadline); they
build the dp2 x tp2 and dp1 x tp4 grids through make_mesh and run
make_auto_inference on both and make_auto_pipeline on dp2 x tp2. While
they run, this process computes the references: the port's inference and
pipeline on one device and the JAX package's ``P.inference`` and
``pipeline_inference``, whose weights (built through torch_port_helpers'
``init0`` and ``jax_generator_variables``, BatchNorm statistics
randomized) reach the port through train/jax_weights.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.config import AnchorConfig, ProjectorConfig, RegressionConfig
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu.train.data import synthetic_projector_batch
from emlight_tpu.train.pipeline import pipeline_inference as j_pipeline
from emlight_tpu_torch.dist import auto as A
from emlight_tpu_torch.dist import fullsize_check
from emlight_tpu_torch.dist.mesh import RankGroup, make_mesh
from emlight_tpu_torch.nn.layers import spectral_sigma
from emlight_tpu_torch.nn.spade import SPADEResnetBlock
from emlight_tpu_torch.nn.sphere_conv import sphere_conv_plain
from emlight_tpu_torch.train import pipeline as TPL
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.jax_weights import densenet_state_from_jax, generator_state_from_jax
from test_auto import TINY_PROJ
from torch_dist_ranks import start_ranks, wait_ranks
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    init0,
    jax_generator_variables,
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
    port_regression_cfg,
    randomize_stats,
)

# tests/test_auto.py::test_auto_pipeline_matches_serial's configs
PIPE_REG = dataclasses.replace(RegressionConfig(), anchors=AnchorConfig(regression_anchors=16),
                               crop_h=48, crop_w=64, block_config=(2,))
PIPE_PROJ = dataclasses.replace(ProjectorConfig(), crop_size=64, ngf=4, ndf=4,
                                anchors=AnchorConfig(n_anchors=16, env_h=32, env_w=64))
GRIDS = {"dp2xtp2": (2, 2), "dp1xtp4": (1, 4)}
DEADLINE_S = 120
# a block's model all-gathers in one forward: mlp_shared's output, each of
# its sphere convs' inputs; and the head's input
GATHERS_PER_BLOCK = {False: 3, True: 4}  # by learned_shortcut


def _generator_state(cfg, seed):
    """JAX's generator init (params, stats) and its port state_dict."""
    g_apply, params, stats = jax_generator_variables(cfg, seed)
    return g_apply, params, stats, generator_state_from_jax(params, stats)


def _jax_proj_state(g_apply, params, stats):
    return P.ProjectorState(step=jnp.zeros((), jnp.int32), g_params=params, g_stats=stats,
                            d_params={}, d_stats={}, g_opt=None, d_opt=None, tx_g=None,
                            tx_d=None, g_apply=g_apply, d_apply=None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inf_cfg, pipe_cfg, reg_cfg = (port_projector_cfg(TINY_PROJ), port_projector_cfg(PIPE_PROJ),
                                  port_regression_cfg(PIPE_REG))
    inf_apply, inf_params, inf_stats, inf_sd = _generator_state(TINY_PROJ, 5)
    pipe_apply, pipe_params, pipe_stats, pipe_sd = _generator_state(PIPE_PROJ, 1)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "run_init", init0)
        reg_state = R.create_state(jax.random.PRNGKey(0), PIPE_REG)
    reg_state = reg_state.replace(batch_stats=randomize_stats(
        jax.tree.map(np.asarray, reg_state.batch_stats), np.random.default_rng(0)))
    batch = synthetic_projector_batch(8, n_anchors=16, crop_size=32, env_hw=(32, 64), seed=6)
    rng = np.random.default_rng(5)
    inp = dict(
        inf_cfg=inf_cfg, inf_sd=inf_sd,
        inf_batch={k: torch.from_numpy(v) for k, v in batch.items()},
        pipe_cfg=pipe_cfg, pipe_sd=pipe_sd, reg_cfg=reg_cfg,
        reg_sd=densenet_state_from_jax(jax.tree.map(np.asarray, reg_state.params),
                                       reg_state.batch_stats),
        crop_reg=rng.random((8, 48, 64, 3), dtype=np.float32),
        crop_proj=rng.random((8, 32, 32, 3), dtype=np.float32),
    )
    work = tmp_path_factory.mktemp("auto")
    procs = start_ranks(work, "auto", inp, world=4)
    try:
        # the references, while the ranks run
        gen = TP.make_models(inf_cfg, device="cpu")
        gen.load_state_dict(inf_sd)
        reg = TR.make_model(reg_cfg, device="cpu")
        reg.load_state_dict(inp["reg_sd"])
        pipe_gen = TP.make_models(pipe_cfg, device="cpu")
        pipe_gen.load_state_dict(pipe_sd)
        port = dict(inference=TP.inference(gen, inp["inf_batch"], inf_cfg),
                    pipeline=TPL.pipeline_inference(reg, pipe_gen, inp["crop_reg"],
                                                    inp["crop_proj"], reg_cfg, pipe_cfg,
                                                    device="cpu"),
                    generator=gen)
        env, pred = j_pipeline(reg_state, _jax_proj_state(pipe_apply, pipe_params, pipe_stats),
                               inp["crop_reg"], inp["crop_proj"], PIPE_REG, PIPE_PROJ)
        ref = dict(inference=np.asarray(P.inference(
                       _jax_proj_state(inf_apply, inf_params, inf_stats), batch, TINY_PROJ)),
                   pipeline=(np.asarray(env), {k: np.asarray(v) for k, v in pred.items()}),
                   params=inf_params, stats=inf_stats)
    finally:
        ranks = wait_ranks(work, procs, DEADLINE_S)
    return dict(ranks=ranks, port=port, jax=ref)


def _rows(rank_out, grid):
    d, dp = rank_out[grid]["data"]
    return slice(d * 8 // dp, (d + 1) * 8 // dp)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_layout_is_jaxs(run, grid):
    """make_mesh lays the 4 ranks out as JAX's reshape(n // tp, tp): rank =
    d·tp + m, the model groups are contiguous ranks."""
    dp, tp = GRIDS[grid]
    for rank, out in enumerate(run["ranks"]):
        assert out[grid]["data"] == (rank // tp, dp)
        assert out[grid]["model"] == (rank % tp, tp)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_auto_inference_matches_one_device(run, grid):
    """Each rank's env maps are its data rows of the port's single-device
    inference at test_auto's bars (rtol 1e-5, atol 1e-5) and of the JAX
    package's P.inference at the port's pipeline bars (rtol 1e-4, atol
    5e-4); the model ranks of one data index hold the same maps."""
    for out in run["ranks"]:
        rows = _rows(out, grid)
        env = out[grid]["env"]
        assert env.shape == (8 // GRIDS[grid][0], 32, 64, 3)
        torch.testing.assert_close(env, run["port"]["inference"][rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(env.numpy(), run["jax"]["inference"][rows], rtol=1e-4,
                                   atol=5e-4)
    tp = GRIDS[grid][1]
    for rank, out in enumerate(run["ranks"]):
        assert torch.equal(out[grid]["env"], run["ranks"][rank - rank % tp][grid]["env"])


def test_auto_pipeline_matches_serial(run):
    """dp2 x tp2: each rank's env maps and heads are its data rows of the
    port's single-device pipeline_inference (env at rtol 1e-5, atol 1e-5;
    the heads at rtol 1e-5, atol 1e-6, the distribution's bar in
    test_auto) and of the JAX package's (env at rtol 1e-4, atol 5e-4; the
    heads at rtol 1e-5, atol 1e-6)."""
    env_ref, pred_ref = run["port"]["pipeline"]
    j_env, j_pred = run["jax"]["pipeline"]
    for out in run["ranks"]:
        rows = _rows(out, "dp2xtp2")
        env, pred = out["pipeline"]
        assert env.shape == (4, 32, 64, 3)
        torch.testing.assert_close(env, env_ref[rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(env.numpy(), j_env[rows], rtol=1e-4, atol=5e-4)
        assert set(pred) == set(j_pred)
        for k in pred:
            torch.testing.assert_close(pred[k], pred_ref[k][rows], rtol=1e-5, atol=1e-6, msg=k)
            np.testing.assert_allclose(pred[k].numpy(), j_pred[k][rows], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _parts(name):
    """How many parts a conv's output is fused from: γ‖β (2), a block's
    mlp_shared (one per norm), else 1."""
    if name.endswith("mlp_gammabeta"):
        return 2
    if name.endswith("mlp_shared"):
        block = name.rsplit(".", 1)[0]
        return 3 if block.startswith("up_") else 2
    return 1


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sharded_state_is_the_jax_leaves_sliced(run, grid):
    """Every split conv's kernel, bias and spectral u are the JAX tree's
    leaves at the rank's channels, Cout/tp of them: of each fused part (γ
    and β, each norm's mlp_shared part) the rank's contiguous slice r, in
    part order; v stays whole; the head (Cout 3) is whole on every rank;
    the SPADE norms hold their slice of the running statistics."""
    tp = GRIDS[grid][1]
    params, stats = run["jax"]["params"], run["jax"]["stats"]
    for out in run["ranks"]:
        r = out[grid]["model"][0]
        convs = out[grid]["convs"]
        assert len(convs) == 44
        for name, c in convs.items():
            kernel = _leaf(params, f"{name}.kernel")
            cout, parts = kernel.shape[-1], _parts(name)
            if name == "sphere_conv1":
                assert cout == 3 and not c["split"]
                idx = np.arange(cout)
            else:
                assert c["split"], name
                per = cout // parts // tp
                idx = np.concatenate([np.arange(p * cout // parts + r * per,
                                                p * cout // parts + (r + 1) * per)
                                      for p in range(parts)])
                assert c["kernel"].shape[-1] == cout // tp
            np.testing.assert_array_equal(c["kernel"].detach().numpy(), kernel[..., idx],
                                          err_msg=name)
            np.testing.assert_array_equal(c["bias"].detach().numpy(),
                                          _leaf(params, f"{name}.bias")[idx], err_msg=name)
            if c["u"] is not None:
                np.testing.assert_array_equal(c["u"].numpy(),
                                              _leaf(stats["spectral"], f"{name}.u")[idx])
                np.testing.assert_array_equal(c["v"].numpy(),
                                              _leaf(stats["spectral"], f"{name}.v"))
        assert len(out[grid]["norms"]) == 18
        for name, (mean, var) in out[grid]["norms"].items():
            full = _leaf(stats["batch_stats"], f"{name}.mean")
            per = full.shape[0] // tp
            np.testing.assert_array_equal(mean.numpy(), full[r * per:(r + 1) * per])
            np.testing.assert_array_equal(
                var.numpy(), _leaf(stats["batch_stats"], f"{name}.var")[r * per:(r + 1) * per])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_split_sigma_is_the_whole_kernels(run, grid):
    """σ of a split spectral-norm conv, each rank's u_rᵀW_r v summed over
    the model ranks, is the whole kernel's uᵀWv with the stored u, v
    (rtol 1e-6: float reassociation)."""
    gen = run["port"]["generator"]
    n = 0
    for out in run["ranks"]:
        for name, c in out[grid]["convs"].items():
            if c["sigma"] is None:
                continue
            whole = gen.get_submodule(name)
            torch.testing.assert_close(c["sigma"], spectral_sigma(whole.kernel, whole.u, whole.v),
                                       rtol=1e-6, atol=0)
            n += 1
    assert n == 4 * 18  # on each of 4 ranks: conv_0 and conv_1 of 7 blocks, conv_s of 4


@pytest.mark.parametrize("grid", list(GRIDS))
def test_model_all_gathers_are_counted(run, grid):
    """One forward all-gathers over model once per split conv input and
    once for each block's mlp_shared output: 26 at ngf 8."""
    blocks = [m for m in run["port"]["generator"].modules() if isinstance(m, SPADEResnetBlock)]
    want = sum(GATHERS_PER_BLOCK[b.learned_shortcut] for b in blocks) + 1
    for out in run["ranks"]:
        assert out[grid]["gathers"] == want > 0


def test_all_gather_channels_joins_part_by_part(run):
    """all_gather_channels(parts=2) over 2 model ranks: part 0 of rank 0,
    part 0 of rank 1, then part 1 of each, channels in order."""
    want = torch.tensor([[100.0 * p + 10 * m + j for p in range(2) for m in range(2)
                          for j in range(3)]])
    for out in run["ranks"]:
        assert torch.equal(out["by_part"], want)


def test_fused_gamma_beta_and_mlp_shared_split_by_part():
    """The port fuses γ‖β (2C outputs) and a block's mlp_shared (nhidden per
    norm) into one conv each. Split by part, rank r's γ and β are slice r
    of γ and of β, and joining the ranks' outputs part by part gives the
    whole conv's; a contiguous cut of the 2C axis would give rank 0 γ
    alone."""
    block = SPADEResnetBlock(8, 4, "batch", nhidden=8,
                             generator=torch.Generator().manual_seed(0)).eval()
    tp, x = 2, torch.rand(2, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    for conv, parts, inp in ((block.norm_0.mlp_gammabeta, 2, x), (block.mlp_shared, 3, x[..., :3])):
        ref = sphere_conv_plain(inp, conv.kernel, conv.bias)
        whole = conv.kernel.shape[-1]
        outs = [A.ColumnSphereConv(conv, RankGroup(pg=None, rank=r, size=tp), parts)(inp)
                for r in range(tp)]
        assert all(o.shape[-1] == whole // tp for o in outs)
        joined = torch.cat([o.reshape(*o.shape[:-1], parts, -1) for o in outs], -1)
        torch.testing.assert_close(joined.reshape(ref.shape), ref, rtol=1e-6, atol=1e-6)
    naive = A.rank_channels(16, RankGroup(pg=None, rank=0, size=2))
    assert naive.max() < 8  # rank 0 would hold γ's channels only
    by_part = A.rank_channels(16, RankGroup(pg=None, rank=0, size=2), parts=2)
    assert by_part.tolist() == [0, 1, 2, 3, 8, 9, 10, 11]


def test_grid_and_placement_refusals(monkeypatch):
    """make_mesh refuses a world that does not divide by tp, and tp > 1
    without ranks; auto_shard_state refuses other modules, a second
    placement and a train state built over another group than the mesh's
    data group; the train steps refuse a state not placed on their mesh;
    fullsize_check refuses more --devices than cards (nothing spawned); the
    serving functions refuse a generator placed on another mesh or left in
    train mode, and a CUDA request without CUDA."""
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(RankGroup(pg=None, rank=0, size=4), 3)
    with pytest.raises(ValueError, match="needs a group"):
        make_mesh(None, 2)
    one = make_mesh(None)
    cfg = port_projector_cfg(dataclasses.replace(PIPE_PROJ, ngf=2))
    gen = TP.make_models(cfg, device="cpu")
    with pytest.raises(ValueError, match="not placed on this mesh"):
        A.make_auto_inference(cfg, one)(gen, {})
    A.auto_shard_state(gen, one)
    with pytest.raises(ValueError, match="already placed"):
        A.auto_shard_state(gen, one)
    with pytest.raises(TypeError, match="SPADEGenerator or a DenseNet"):
        A.auto_shard_state(torch.nn.Linear(2, 2), one)
    with pytest.raises(ValueError, match="not placed on this mesh"):
        A.make_auto_inference(cfg, make_mesh(None))(gen, {})
    with pytest.raises(RuntimeError, match="eval mode"):
        A.make_auto_inference(cfg, one)(gen.train(), {})
    gen.eval()
    with pytest.raises(ValueError, match="not built over this mesh's data group"):
        A.auto_shard_state(TP.create_state(cfg, device="cpu",
                                           group=RankGroup(pg=None, rank=0, size=1)), one)
    state = A.auto_shard_state(TP.create_state(cfg, device="cpu"), one)
    with pytest.raises(ValueError, match="not placed on this mesh"):
        A.make_auto_projector_steps(cfg, make_mesh(None))[2](state, {})
    reg_cfg = port_regression_cfg(PIPE_REG)
    with pytest.raises(ValueError, match="not placed on this mesh"):
        A.make_auto_regression_step(reg_cfg, one)(TR.create_state(reg_cfg, device="cpu"), {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--devices 4: 1 card"):
        fullsize_check.main(["--devices", "4", "--tp", "2"])
    reg = TR.make_model(port_regression_cfg(PIPE_REG), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        A.make_auto_pipeline(port_regression_cfg(PIPE_REG), cfg, one)(
            reg, gen, np.zeros((1, 48, 64, 3), np.float32), np.zeros((1, 32, 32, 3), np.float32))
