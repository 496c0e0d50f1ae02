"""One rank of a data-parallel group of the port on the CPU, for the tests.

    python tests/torch_dist_ranks.py WORK JOB

runs as rank $RANK of $WORLD_SIZE: it joins a gloo group whose FileStore
is WORK/store (no TCP port, so parallel test workers cannot collide), with
one intra-op thread and a 60 s timeout on every collective, runs JOB on
the inputs the test left in WORK/inputs.pickle, and writes what the test
compares into WORK/rank{RANK}.pickle. JOBs:

- ``checks``: tests/test_torch_dist.py's multi-rank checks (BatchNorm
  over the group, the Sinkhorn diameter, the regression step on both
  routes in float64, the serving functions);
- ``gan``: tests/test_torch_gan_fused.py's (the G, D and fused steps with
  VGG);
- ``cli``: each command line of inputs["argvs"] through its CLI's main
  with --parallel, inside this group;
- ``auto``: tests/test_torch_auto.py's (tensor-parallel serving over the
  dp2 x tp2 and dp1 x tp4 grids of 4 ranks);
- ``auto_train``: tests/test_torch_auto_train.py's (tensor-parallel
  training over the same grids, the differentiable collectives and
  fullsize_check's rank body).

``start_ranks`` and ``wait_ranks`` are the test side: they start the
ranks with torchrun's environment and join them with a deadline.
``spawned_clis`` and ``one_rank_hangs`` are ``main``s for
emlight_tpu_torch/cli/_common.py's ``spawn_ranks``: each spawned rank runs
``run_cli``'s command lines, or rank 1 hangs.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TIMEOUT_S = 60  # every collective; a rank that dies fails the others this fast


def start_ranks(work: Path, job: str, inputs: dict, world: int = 2) -> list:
    """Write the inputs and start `world` ranks running `job` in the
    background; returns their Popen handles (for ``wait_ranks``)."""
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "inputs.pickle", "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(HERE.parent), os.environ.get("PYTHONPATH", "")]))
        log = open(work / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__)), str(work), job],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(work: Path, procs: list, deadline_s: float) -> list:
    """Join the ranks; past the deadline kill them all. Raises unless every
    rank exited 0; returns each rank's results."""
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = "\n".join(f"-- rank {r} (exit {p.returncode}):\n" + (work / f"rank{r}.log").read_text()
                     for r, p in enumerate(procs))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"a rank failed or passed the {deadline_s} s deadline\n{logs}")
    out = []
    for r in range(len(procs)):
        with open(work / f"rank{r}.pickle", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the rank side ------------------------------------------------------------------


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def check_batchnorm(inp, group, mesh):
    """BatchNorm over the group on the rank's rows: outputs, the running
    statistics, the input's gradient and the parameters' local parts."""
    import torch

    from emlight_tpu_torch.nn.layers import BatchNorm

    rows = mesh.shard_rows(len(inp["x"]), group)
    bn = BatchNorm(inp["x"].shape[-1], affine=True, group=group).double().train()
    bn.load_state_dict(inp["bn"])
    x = inp["x"][rows].clone().requires_grad_(True)
    y = bn(x)
    (y * inp["w"][rows]).sum().backward()
    return dict(y=y.detach(), x_grad=x.grad, state=_state(bn),
                p_grad={n: p.grad.clone() for n, p in bn.named_parameters()})


def check_sinkhorn(inp, group, mesh):
    """The data diameter over the group: the rank's divergences."""
    from emlight_tpu_torch.losses.sinkhorn import SamplesLoss

    rows = mesh.shard_rows(len(inp["sx"]), group)
    loss = SamplesLoss("sinkhorn", blur=0.025, n_iters=3, group=group)
    return loss(inp["sx"][rows], inp["sy"][rows])


def check_regression(inp, group, mesh):
    """One train_step per route in float64 (Adam at lr 0: the gradients
    stay in .grad and the parameters where they were): the averaged
    gradients, metrics and running statistics."""
    import dataclasses

    import torch

    from emlight_tpu_torch.dist.parallel import make_parallel_regression_step
    from emlight_tpu_torch.nn.densenet import DenseNet
    from emlight_tpu_torch.train import regression as TR

    out = {}
    batch = mesh.shard_batch(inp["reg_batch"], group)
    for route in ("buffer", "standard"):
        cfg = dataclasses.replace(inp["reg_cfg"], train_forward=route)
        model = DenseNet(block_config=cfg.block_config, n_anchors=cfg.anchors.regression_anchors,
                         input_hw=(cfg.crop_h, cfg.crop_w), dtype=torch.float64,
                         group=group).double()
        model.load_state_dict(inp["reg_sd"])
        state = TR.RegressionState(
            cfg=cfg, model=model, opt=torch.optim.Adam(model.parameters(), lr=0.0),
            apply_fn=TR.make_train_apply(cfg) if route == "buffer" else TR.standard_apply,
            group=group)
        metrics = make_parallel_regression_step(group)(state, batch)
        out[route] = dict(grads=_grads(model), metrics=metrics, state=_state(model))
    return out


def check_gan(inp, group, mesh):
    """tests/test_torch_gan_fused.py's multi-rank checks: from the test's
    weights (inputs g_sd, d_sd) on the rank's rows of one batch, with VGG
    (random_vgg19_params(0)), the G step and the D step at lr 0 and the
    fused step with Adam at lr 1e-3, each from those weights: the
    gradients, averaged metrics and fakes of each, the states after the
    fused step, and G's weights before it."""
    import dataclasses

    from emlight_tpu_torch.dist.parallel import (make_parallel_fused_step,
                                                 make_parallel_projector_steps)
    from emlight_tpu_torch.nn.vgg import VGG19Features, random_vgg19_params
    from emlight_tpu_torch.train import projector as TP

    vgg = VGG19Features(random_vgg19_params(0), device="cpu")
    g_step, d_step = make_parallel_projector_steps(group, vgg)
    fused = make_parallel_fused_step(group, vgg)
    batch = mesh.shard_batch(inp["gan_batch"], group)

    def fresh():
        state = TP.create_state(dataclasses.replace(inp["gan_cfg"], lr=0.0), device="cpu",
                                group=group)
        state.g.load_state_dict(inp["g_sd"], strict=True)
        state.d.load_state_dict(inp["d_sd"], strict=True)
        return state

    out = {}
    state = fresh()
    m, fake = g_step(state, batch)
    out["g"] = dict(metrics=m, fake=fake, grads=_grads(state.g))
    state = fresh()
    out["d"] = dict(metrics=d_step(state, batch), grads=_grads(state.d))
    state = fresh()
    before = _state(state.g)
    state.lr_g = state.lr_d = lambda step: 1e-3
    m, fake = fused(state, batch)
    out["fused"] = dict(metrics=m, fake=fake, g_grads=_grads(state.g), d_grads=_grads(state.d),
                        g_state=_state(state.g), d_state=_state(state.d), g_before=before)
    return out


def check_serving(inp, group, mesh):
    """The serving functions on a ragged global batch of 3: the rows each
    rank served and their outputs."""
    from emlight_tpu_torch.dist import parallel as DP
    from emlight_tpu_torch.train import projector as TP
    from emlight_tpu_torch.train import regression as TR

    reg = TR.make_model(inp["reg_cfg"], device="cpu", seed=3)
    gen = TP.make_models(inp["gan_cfg"], device="cpu", seed=4)
    rows, heads = DP.make_parallel_predict(inp["reg_cfg"], group)(reg, inp["crop_reg"])
    rows_i, env_i = DP.make_parallel_inference(inp["gan_cfg"], group)(gen, inp["gan_serve"])
    rows_p, env_p, pred_p = DP.make_parallel_pipeline(inp["reg_cfg"], inp["gan_cfg"], group)(
        reg, gen, inp["crop_reg"], inp["crop_proj"], "cpu")
    return dict(predict=(rows, heads), inference=(rows_i, env_i),
                pipeline=(rows_p, env_p, pred_p))


def check_auto(inp, group, mesh):
    """tests/test_torch_auto.py's multi-rank checks on 4 ranks: both grids
    built through make_mesh (every rank creates every subgroup), then on
    each the sharded generator's inference on the rank's data rows, with
    its grid coordinates, its column convs' slices, σ and split flags, its
    sliced norms' statistics and the model all-gathers of one forward; the
    dp2 x tp2 pipeline; and all_gather_channels' layout by part."""
    import torch

    from emlight_tpu_torch.dist import auto as A
    from emlight_tpu_torch.train import projector as TP
    from emlight_tpu_torch.train import regression as TR

    def generator(cfg, sd, grid):
        gen = TP.make_models(cfg, device="cpu")
        gen.load_state_dict(sd)
        return A.auto_shard_state(gen, grid)

    out = {}
    grids = {name: mesh.make_mesh(group, tp) for name, tp in (("dp2xtp2", 2), ("dp1xtp4", 4))}
    for name, grid in grids.items():
        gen = generator(inp["inf_cfg"], inp["inf_sd"], grid)
        mesh.all_gather_channels.calls = 0
        env = A.make_auto_inference(inp["inf_cfg"], grid)(
            gen, A.auto_shard_batch(inp["inf_batch"], grid))
        gathers = mesh.all_gather_channels.calls
        with torch.no_grad():
            convs = {n: dict(kernel=m.kernel, bias=m.bias, u=m.u, v=m.v, split=m.split,
                             sigma=None if m.u is None else m.sigma())
                     for n, m in gen.named_modules() if isinstance(m, A.ColumnSphereConv)}
        norms = {n: m.running_stats() for n, m in gen.named_modules()
                 if n.endswith("param_free_norm")}
        out[name] = dict(env=env, gathers=gathers, convs=convs, norms=norms,
                         data=(grid.data.rank, grid.data.size),
                         model=(grid.model.rank, grid.model.size))
    grid = grids["dp2xtp2"]
    reg = TR.make_model(inp["reg_cfg"], device="cpu")
    reg.load_state_dict(inp["reg_sd"])
    gen = generator(inp["pipe_cfg"], inp["pipe_sd"], grid)
    out["pipeline"] = A.make_auto_pipeline(inp["reg_cfg"], inp["pipe_cfg"], grid)(
        A.auto_shard_state(reg, grid), gen, A.auto_shard_batch(inp["crop_reg"], grid),
        A.auto_shard_batch(inp["crop_proj"], grid), "cpu")
    # two parts of 3 channels per rank, each value naming (part, model rank, channel)
    m = grid.model.rank
    x = torch.tensor([[100.0 * p + 10 * m + j for p in range(2) for j in range(3)]])
    out["by_part"] = mesh.all_gather_channels(x, grid.model, parts=2)
    return out


def _sliced(model):
    """name -> the channels of the whole leaf this rank holds, for every
    kernel, bias and u of a split ColumnSphereConv (the other leaves, and
    the sliced norms' statistics, which hold contiguous slices, are not
    listed)."""
    from emlight_tpu_torch.dist.auto import ColumnSphereConv

    return {f"{n}.{leaf}": m.channels for n, m in model.named_modules()
            if isinstance(m, ColumnSphereConv) and m.split for leaf in ("kernel", "bias", "u")}


def _gather_checks(grids, mesh):
    """all_gather_channels and split_channels forward and backward on small
    tensors: rank m's slice of the gathered tensor and its gradient under a
    loss whose weights differ by model rank (split readers: the cotangents
    are summed) or not (a whole reader: sliced alone); by part over tp 2."""
    import torch

    out = {}
    model = grids["dp1xtp4"].model
    m = model.rank
    for name, reader_split in (("split_reader", True), ("whole_reader", False)):
        x = (torch.arange(6.0).reshape(2, 3) + 10 * m).requires_grad_(True)
        y = mesh.all_gather_channels(x, model, partial_grad=reader_split)
        w = torch.arange(24.0).reshape(2, 12) * ((m + 1) if reader_split else 1)
        (y * w).sum().backward()
        out[name] = dict(y=y.detach(), grad=x.grad)
    x = torch.arange(16.0).reshape(2, 8).requires_grad_(True)
    y = mesh.split_channels(x, model)
    (y * (m + 1)).sum().backward()
    out["split"] = dict(y=y.detach(), grad=x.grad)
    model = grids["dp2xtp2"].model
    x = (torch.arange(6.0)[None] + 10 * model.rank).requires_grad_(True)
    y = mesh.all_gather_channels(x, model, parts=2, partial_grad=(True, False))
    w = torch.arange(12.0)[None] * torch.tensor([model.rank + 1.0] * 6 + [1.0] * 6)
    (y * w).sum().backward()
    out["by_part"] = dict(y=y.detach(), grad=x.grad)
    return out


def check_auto_train(inp, group, mesh):
    """tests/test_torch_auto_train.py's multi-rank checks on 4 ranks: on the
    dp2 x tp2 and dp1 x tp4 grids (make_mesh; every rank creates every
    subgroup) a regression step and a fused G+D step from the test's
    weights (their states built over the grid's data group and placed with
    auto_shard_state), with the metrics, the averaged gradients, the state
    after the step, each split leaf's channels, the collectives of the
    fused step and the placed G's global gradient norm before and after
    clipping to half of it; on dp2 x tp2 a G then a D step from seed 2;
    the differentiable collectives; fullsize_check's rank body at the
    test's size."""
    import torch

    from emlight_tpu_torch.dist import auto as A
    from emlight_tpu_torch.dist.fullsize_check import run_rank
    from emlight_tpu_torch.train import projector as TP
    from emlight_tpu_torch.train import regression as TR
    from emlight_tpu_torch.train.optim import clip_by_global_norm, grads_global_norm

    grids = {name: mesh.make_mesh(group, tp) for name, tp in (("dp2xtp2", 2), ("dp1xtp4", 4))}
    gan_cfg = inp["gan_cfg"]

    def gan_state(grid, seed=0, sds=None):
        state = TP.create_state(gan_cfg, device="cpu", seed=seed, group=grid.data)
        if sds is not None:
            state.g.load_state_dict(sds[0], strict=True)
            state.d.load_state_dict(sds[1], strict=True)
        return A.auto_shard_state(state, grid)

    def whole_leaves(*models):
        return {f"{i}.{n}": p.detach().clone() for i, mod in enumerate(models)
                for n, p in mod.named_parameters() if not mesh.is_model_split(p)}

    out = {}
    for name, grid in grids.items():
        reg = TR.create_state(inp["reg_cfg"], device="cpu", group=grid.data)
        reg.model.load_state_dict(inp["reg_sd"], strict=True)
        A.auto_shard_state(reg, grid)
        metrics = A.make_auto_regression_step(inp["reg_cfg"], grid)(
            reg, A.auto_shard_batch(inp["reg_batch"], grid))
        o = dict(data=(grid.data.rank, grid.data.size), model=(grid.model.rank, grid.model.size),
                 reg=dict(metrics=metrics, state=_state(reg.model), grads=_grads(reg.model)))
        state = gan_state(grid, sds=(inp["g_sd"], inp["d_sd"]))
        _, _, fused = A.make_auto_projector_steps(gan_cfg, grid)
        mesh.all_gather_channels.calls = mesh.all_gather_channels.grad_calls = 0
        mesh.split_channels.grad_calls = 0
        metrics, fake = fused(state, A.auto_shard_batch(inp["gan_batch"], grid))
        o["fused"] = dict(
            metrics=metrics, fake=fake, g_grads=_grads(state.g), d_grads=_grads(state.d),
            g_state=_state(state.g), d_state=_state(state.d), sliced=_sliced(state.g),
            collectives=(mesh.all_gather_channels.calls, mesh.all_gather_channels.grad_calls,
                         mesh.split_channels.grad_calls),
            whole=whole_leaves(state.g, state.d), step=(state.step, state.d_step))
        norm = grads_global_norm(state.g.parameters(), grid.model)
        clip_by_global_norm(state.g.parameters(), norm.item() / 2, grid.model)
        o["norm"] = (norm, grads_global_norm(state.g.parameters(), grid.model))
        out[name] = o
    grid = grids["dp2xtp2"]
    state = gan_state(grid, seed=2)
    g_step, d_step, _ = A.make_auto_projector_steps(gan_cfg, grid)
    batch = A.auto_shard_batch(inp["alt_batch"], grid)
    g_metrics, fake = g_step(state, batch)
    d_metrics = d_step(state, batch)
    out["alternating"] = dict(metrics={**g_metrics, **d_metrics}, fake_shape=tuple(fake.shape),
                              step=state.step, whole=whole_leaves(state.g, state.d))
    out["gathers"] = _gather_checks(grids, mesh)
    out["fullsize"] = run_rank(group, torch.device("cpu"), **inp["fullsize"])
    return out


def run_cli(inp, group, mesh):
    import importlib

    for cli, argv in inp["argvs"]:
        importlib.import_module(f"emlight_tpu_torch.cli.{cli}").main(argv + ["--parallel"])
    return {}


def one_rank_hangs(seconds: float) -> str:
    """A spawned rank's work for the straggler check: rank 1 sleeps
    `seconds`, rank 0 returns at once."""
    if os.environ["RANK"] == "1":
        time.sleep(seconds)
    return "rank 0 done"


def spawned_clis(argvs: list) -> None:
    """A spawned rank's work: each (cli, argv) of `argvs` through its CLI's
    main with --parallel, in the group spawn_ranks joined, one intra-op
    thread."""
    import torch

    torch.set_num_threads(1)
    run_cli({"argvs": argvs}, None, None)


def main(work: str, job: str) -> None:
    import torch

    torch.set_num_threads(1)
    from emlight_tpu_torch.dist import mesh

    work = Path(work)
    with open(work / "inputs.pickle", "rb") as f:
        inp = pickle.load(f)
    group, created = mesh.join(torch.device("cpu"), f"file://{work / 'store'}",
                               timeout_s=TIMEOUT_S)
    try:
        if job == "checks":
            out = {name: fn(inp, group, mesh) for name, fn in (
                ("bn", check_batchnorm), ("sinkhorn", check_sinkhorn),
                ("regression", check_regression), ("serving", check_serving))}
        elif job == "gan":
            out = check_gan(inp, group, mesh)
        elif job == "auto":
            out = check_auto(inp, group, mesh)
        elif job == "auto_train":
            out = check_auto_train(inp, group, mesh)
        else:
            out = run_cli(inp, group, mesh)
        mesh.barrier(group)
    finally:
        mesh.leave(created)
    with open(work / f"rank{group.rank}.pickle", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
