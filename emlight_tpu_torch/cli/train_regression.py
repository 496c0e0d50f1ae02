"""Regression training on the card (replaces RegressionNetwork/train.py + run.sh).

Port of emlight_tpu/cli/train_regression.py: the same flags, outputs and
cadence. Trains the DenseNet anchor regressor with the reference's loss
recipe (Sinkhorn EMD x1000 + L2 terms, Adam 1e-4, batch 16), and writes:

- {out_dir}/opt.json + opt.txt (the run's flags; --resume reloads them);
- checkpoints/latest.msgpack every --save_every steps and at the end, and
  {epoch}_net.msgpack at the end: the whole RegressionState (model, BatchNorm
  statistics, Adam moments and count) in the JAX package's format, so
  either package resumes the other's run;
- metrics.csv (a row per step) and iter.json (the resume bookmark);
- summary/{step}.png every --summary_every steps: crop | GT env | pred env
  (the JAX CLI writes .jpg).

A resumed run restarts the data order at epoch 0 and stops at the total
step count, as the JAX CLI does (train/data.py::batched).

--parallel trains data-parallel over one rank per card (cli/_common.py::
launch; dist/parallel.py): each rank reads its rows of every global batch
(--batch_size must split over the ranks), BatchNorm takes the global
batch's moments, the gradients are averaged over the ranks, and rank 0
writes every file, the metrics averaged over the ranks. The JAX CLI writes
no summary under --parallel; the port's rank 0 renders it from its rows,
whose first is the global batch's.

Usage:
  python -m emlight_tpu_torch.cli.train_regression --data_root /data/LavalIndoor \
      --out_dir runs/regression [--epochs 500] [--resume] [--device cpu]
  python -m emlight_tpu_torch.cli.train_regression --synthetic 128 --epochs 2 ...
  torchrun --nproc_per_node 4 -m emlight_tpu_torch.cli.train_regression --parallel ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import SinkhornConfig
from ..dist import mesh
from ..train import regression as R
from ..train.checkpoint import latest_checkpoint, restore_train_state, save_train_state
from ..train.config_io import apply_saved_defaults, report_overrides, save_run_config
from ..train.data import (RegressionDataset, batched, device_prefetch, prefetch,
                          synthetic_regression_batch)
from ..train.loop import IterationTimer, MetricsLogger, NaNGuard, profile_trace, render_summary
from ._common import (PARALLEL_HELP, add_device_flag, checked_device, launch, next_timed,
                      rank_count, regression_config)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", default=None, help="Laval layout: {root}/pkl + {root}/crop")
    ap.add_argument("--synthetic", type=int, default=0, help="train on N synthetic samples")
    ap.add_argument("--out_dir", default="runs/regression")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--anchors", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--parallel", action="store_true",
                    help="data-parallel over the ranks, --batch_size the global batch; "
                         + PARALLEL_HELP)
    ap.add_argument("--summary_every", type=int, default=100)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--sinkhorn_backend", choices=("auto", "jnp"), default="auto",
                    help="the Sinkhorn loop; both names select the port's one loop (in "
                         "the JAX package both are its XLA loop)")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler Chrome trace of the loop here")
    ap.add_argument("--block_config", default="16,16,16",
                    help="DenseNet blocks, e.g. '2,2' for smoke runs")
    ap.add_argument("--crop", default="192,256", help="input H,W")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="compute dtype (bfloat16: convs, BatchNorm outputs and the fc in "
                         "bf16; parameters, statistics and the heads float32)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize dense layers in the standard train forward; as in "
                         "the JAX package, the default buffer forward does not read it")
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="global-norm gradient clip; 0 = off (reference parity). "
                         "Changes optimizer-state structure — keep consistent "
                         "across train/resume")
    ap.add_argument("--log_grad_norms", action="store_true",
                    help="log per-head + global gradient norms (the "
                         "reference's check_grad probes as metrics)")
    ap.add_argument("--load_config", default=None,
                    help="opt.json (or run dir) whose flags become defaults; "
                         "--resume picks up {out_dir}/opt.json automatically")
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the checkpoint's step if one was restored, the
    loop's first and final step, its waits on the data queue (s), its wall
    time (s) and, on the card, each step's device time (ms): rank 0's under
    --parallel."""
    ap = _parser()
    dev = checked_device(ap, argv)
    saved = apply_saved_defaults(ap, argv)
    args = ap.parse_args(argv)
    ranks = rank_count(args.parallel, dev)
    if args.batch_size % ranks:
        raise SystemExit(f"--batch_size {args.batch_size} does not split over the {ranks} "
                         "ranks of --parallel")
    return launch(main, argv, args.parallel, dev,
                  lambda d, group: _train(args, saved, d, group))


def _train(args, saved: dict | None, dev, group) -> dict:
    """The run on `dev`, as one rank of `group` under --parallel."""
    writer = group is None or group.rank == 0
    if writer:
        report_overrides(saved, args)
        save_run_config(args.out_dir, args)

    cfg = regression_config(args.anchors, args.crop, args.block_config, args.clip_grad_norm,
                            sinkhorn=SinkhornConfig(backend="auto"),
                            batch_size=args.batch_size, lr=args.lr, dtype=args.dtype,
                            remat=args.remat, log_grad_norms=args.log_grad_norms)
    state = R.create_state(cfg, device=dev, group=group)
    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    restored = None
    if args.resume and latest_checkpoint(ckpt_dir):
        restored = restore_train_state(latest_checkpoint(ckpt_dir), state).step
        if writer:
            print(f"restored checkpoint at step {restored}")
    mesh.replicate([state.model], group)

    if args.synthetic:
        def epochs():
            rng = np.random.default_rng(0)
            while True:
                for _ in range(args.synthetic // args.batch_size):
                    yield mesh.shard_batch(synthetic_regression_batch(
                        args.batch_size, args.anchors, (cfg.crop_h, cfg.crop_w),
                        seed=int(rng.integers(1 << 31)),
                    ), group)
        batches = epochs()
        steps_per_epoch = max(args.synthetic // args.batch_size, 1)
    else:
        assert args.data_root, "--data_root or --synthetic required"
        ds = RegressionDataset(args.data_root, crop_hw=(cfg.crop_h, cfg.crop_w))
        if writer:
            print(f"dataset: {len(ds)} pairs")
        batches = prefetch(batched(ds, args.batch_size, epochs=args.epochs, group=group),
                           depth=4)
        steps_per_epoch = len(ds) // args.batch_size

    logger = MetricsLogger(args.out_dir, writer=writer)
    timer = IterationTimer(args.out_dir, args.batch_size, device=dev, writer=writer).resume()
    guard = NaNGuard()
    total_steps = args.epochs * steps_per_epoch
    start, waits, t_loop = timer.step, [], time.perf_counter()

    with profile_trace(args.profile_dir):
        # device_prefetch copies batch i+1 onto the card while step i runs
        it = device_prefetch(batches, dev)
        while timer.step < total_steps:
            item = next_timed(it, waits)
            if item is None:
                break
            tb, _rest = item
            with timer:
                metrics = R.train_step(state, tb)
            # the JAX step returns its metrics from a jitted function, keys sorted
            metrics = dict(sorted(metrics.items()))
            guard.check(timer.step, metrics)
            logger.log(timer.step, metrics, timer.stats())

            if writer and args.summary_every and timer.step % args.summary_every == 0:
                _, pred = R.eval_step(state, tb)
                np_ = lambda t: t.float().cpu().numpy()  # noqa: E731
                render_summary(
                    np_(tb["crop"][0]), np_(pred["distribution"][0]),
                    np_(tb["distribution"][0]), float(pred["intensity"][0, 0]),
                    float(tb["intensity"][0]), np_(pred["rgb_ratio"][0]),
                    np_(tb["rgb_ratio"][0]), cfg.anchors.regression_anchors,
                    os.path.join(args.out_dir, "summary", f"{timer.step}.png"),
                    intensity_scale=cfg.anchors.intensity_scale,
                )
            if writer and args.save_every and timer.step % args.save_every == 0:
                save_train_state(ckpt_dir, state, "latest")
                timer.record()
    loop_s = time.perf_counter() - t_loop

    if writer:
        save_train_state(ckpt_dir, state, "latest")
        epoch_tag = timer.step // max(steps_per_epoch, 1)
        save_train_state(ckpt_dir, state, f"{epoch_tag}_net")
        timer.record()
        print(f"done at step {timer.step}; stats {timer.stats()}")
    return {"restored": restored, "start": start, "step": timer.step, "wait_s": waits,
            "loop_s": loop_s, "step_ms": timer.device_ms}


if __name__ == "__main__":
    main()
