"""GenProjector adversarial training on the card (replaces GenProjector/train.py +
model_trainer.py + train_laval.sh).

Port of emlight_tpu/cli/train_projector.py's single-device loop: the same
flags, outputs and cadence. TTUR hinge GAN with mask-weighted feature
matching; G every --d_steps_per_g iterations, D every iteration
(train.py:29-37). Writes:

- {out_dir}/opt.json + opt.txt (the run's flags; --resume reloads them);
- checkpoints/latest.msgpack every --save_every steps and at the end: the
  whole ProjectorState (G and D, BatchNorm statistics, spectral u and v,
  both Adams' moments and counts) in the JAX package's format, so either
  package resumes the other's run;
- metrics.csv (a row per iteration) and iter.json (the resume bookmark);
- web/{step}.png every --display_every steps that ran G: real | fake,
  tonemapped (the JAX CLI writes .jpg).

The objective and the loop as the JAX CLI's: the VGG19 perceptual term with
--vgg_npz (or $EMLIGHT_VGG19_NPZ) or --vgg_random, and without it when
neither gives weights; --fused takes both updates from one generator
forward (fused_gan_step); --scan_steps N runs N fused steps per chunk
(scanned_fused_steps) with no host synchronisation inside it, the chunk's
metrics read once, logged per step, and display and save fired once at a
chunk boundary that crossed their cadence. Both need --d_steps_per_g 1.
--parallel exits with its ROADMAP.md §1 item, "Multi-GPU".

Usage:
  python -m emlight_tpu_torch.cli.train_projector --data_root /data/LavalIndoor \
      --out_dir runs/projector [--epochs 200] [--resume] [--device cpu]
  python -m emlight_tpu_torch.cli.train_projector --synthetic 64 --epochs 2 --ngf 8 ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.hdr import TONEMAP_VIZ
from ..core.png import write_png
from ..nn.vgg import VGG19Features, load_vgg19_params, random_vgg19_params
from ..train import projector as P
from ..train.checkpoint import latest_checkpoint, restore_train_state, save_train_state
from ..train.config_io import apply_saved_defaults, report_overrides, save_run_config
from ..train.data import (ProjectorDataset, batched, device_prefetch, prefetch,
                          synthetic_projector_batch)
from ..train.loop import IterationTimer, MetricsLogger, NaNGuard
from ._common import (PARALLEL_NOT_PORTED, add_device_flag, checked_device, next_timed,
                      projector_config, refuse)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--out_dir", default="runs/projector")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64)
    ap.add_argument("--crop_size", type=int, default=256, help="2x env height")
    ap.add_argument("--anchors", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--gan_mode", default="hinge", choices=("hinge", "ls", "original", "w"))
    ap.add_argument("--d_steps_per_g", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="bfloat16: conv compute in bf16 (f32 accumulation/params)")
    ap.add_argument("--vgg_npz", default=None)
    ap.add_argument("--vgg_random", action="store_true",
                    help="enable the VGG x5 perceptual term with random-init "
                         "weights when no pretrained npz exists (full "
                         "reference loss graph/cost; random-feature L1 is a "
                         "weaker perceptual proxy than pretrained)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--parallel", action="store_true",
                    help="not ported yet (ROADMAP.md §1, \"Multi-GPU\"): exits")
    ap.add_argument("--display_every", type=int, default=100)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="global-norm gradient clip for G and D; 0 = off "
                         "(reference parity — but the unclipped recipe can NaN "
                         "on harsh lights). Keep consistent across train/resume")
    ap.add_argument("--fused", action="store_true",
                    help="fused G+D step sharing one generator forward (Jacobi "
                         "updates instead of the reference's alternating ones; "
                         "needs d_steps_per_g=1)")
    ap.add_argument("--scan_steps", type=int, default=0,
                    help="run N fused G+D iterations per chunk with no host "
                         "synchronisation between them; implies the fused "
                         "step's Jacobi updates; needs d_steps_per_g=1")
    ap.add_argument("--load_config", default=None,
                    help="opt.json (or run dir) whose flags become defaults; "
                         "--resume picks up {out_dir}/opt.json automatically")
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the checkpoint's step if one was restored, the
    loop's first and final step, its waits on the data queue (s), its wall
    time (s) and, on the card, each step's device time (ms)."""
    ap = _parser()
    dev = checked_device(ap, argv)
    saved = apply_saved_defaults(ap, argv)
    args = ap.parse_args(argv)
    refuse(ap, (args.parallel, PARALLEL_NOT_PORTED))  # an opt.json's too
    if (args.fused or args.scan_steps > 1) and args.d_steps_per_g != 1:
        raise SystemExit("--fused/--scan_steps require d_steps_per_g=1 (the "
                         "fused step takes one G and one D update per iteration)")
    report_overrides(saved, args)
    save_run_config(args.out_dir, args)

    cfg = projector_config(args, batch_size=args.batch_size, lr=args.lr,
                           gan_mode=args.gan_mode, d_steps_per_g=args.d_steps_per_g)
    env_h, env_w = args.crop_size // 2, args.crop_size
    vgg_params = load_vgg19_params(args.vgg_npz)
    if vgg_params is not None:
        print("VGG19 perceptual loss enabled (pretrained npz)")
    elif args.vgg_random:
        vgg_params = random_vgg19_params()
        print("VGG19 perceptual loss enabled (random-init weights)")
    else:
        print("VGG19 weights unavailable -> perceptual term disabled (see nn/vgg.py)")
    vgg = VGG19Features(vgg_params, device=dev) if vgg_params is not None else None

    if args.synthetic:
        steps_per_epoch = max(args.synthetic // args.batch_size, 1)

        def gen():
            rng = np.random.default_rng(0)
            while True:
                for _ in range(steps_per_epoch):
                    yield synthetic_projector_batch(
                        args.batch_size, args.anchors, args.crop_size // 2,
                        (env_h, env_w), seed=int(rng.integers(1 << 31)),
                    )
        batches = gen()
    else:
        assert args.data_root, "--data_root or --synthetic required"
        ds = ProjectorDataset(args.data_root, crop_size=args.crop_size // 2)
        print(f"dataset: {len(ds)} samples")
        steps_per_epoch = max(len(ds) // args.batch_size, 1)
        batches = prefetch(batched(ds, args.batch_size, epochs=args.epochs), depth=4)

    state = P.create_state(cfg, device=dev, steps_per_epoch=steps_per_epoch)
    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    restored = None
    if args.resume and latest_checkpoint(ckpt_dir):
        restored = restore_train_state(latest_checkpoint(ckpt_dir), state).step
        print(f"restored checkpoint at step {restored}")

    logger = MetricsLogger(args.out_dir)
    timer = IterationTimer(args.out_dir, args.batch_size, device=dev).resume()
    guard = NaNGuard()
    total_steps = args.epochs * steps_per_epoch
    start, waits, t_loop = timer.step, [], time.perf_counter()

    loop = _run_scanned if args.scan_steps > 1 else _run_steps
    loop(args, state, device_prefetch(batches, dev), vgg, total_steps, timer, logger, guard,
         waits, ckpt_dir)
    loop_s = time.perf_counter() - t_loop

    save_train_state(ckpt_dir, state, "latest")
    timer.record()
    print(f"done at step {timer.step}; stats {timer.stats()}")
    return {"restored": restored, "start": start, "step": timer.step, "wait_s": waits,
            "loop_s": loop_s, "step_ms": timer.device_ms}


def _display(out_dir: str, step: int, fake: torch.Tensor, real: torch.Tensor) -> None:
    """web/{step}.png: the first real | fake pair of the batch, tonemapped."""
    tone_f, _ = TONEMAP_VIZ(fake[0].float().cpu().numpy())
    tone_r, _ = TONEMAP_VIZ(real[0].float().cpu().numpy())
    os.makedirs(os.path.join(out_dir, "web"), exist_ok=True)
    write_png(os.path.join(out_dir, "web", f"{step}.png"),
              (np.hstack([tone_r, tone_f]) * 255).astype(np.uint8))


def _run_steps(args, state, it, vgg, total_steps, timer, logger, guard, waits,
               ckpt_dir) -> None:
    """One step per batch: --fused's fused_gan_step, or G every
    --d_steps_per_g iterations and D every iteration (train.py:29-37)."""
    while timer.step < total_steps:
        item = next_timed(it, waits)
        if item is None:
            break
        tb, _rest = item
        with timer:
            # each step's keys sorted, as the JAX steps return them from
            # jitted functions
            if args.fused:
                metrics, fake = P.fused_gan_step(state, tb, vgg)
                metrics = dict(sorted(metrics.items()))
            else:
                metrics = {}
                if timer.step % args.d_steps_per_g == 0:
                    g_metrics, fake = P.generator_step(state, tb, vgg)
                    metrics.update(sorted(g_metrics.items()))
                metrics.update(sorted(P.discriminator_step(state, tb).items()))
        guard.check(timer.step, metrics)
        logger.log(timer.step, metrics, timer.stats())

        if args.display_every and timer.step % args.display_every == 0 and "loss_G" in metrics:
            _display(args.out_dir, timer.step, fake, tb["warped"])
        if args.save_every and timer.step % args.save_every == 0:
            save_train_state(ckpt_dir, state, "latest")
            timer.record()


def _run_scanned(args, state, it, vgg, total_steps, timer, logger, guard, waits,
                 ckpt_dir) -> None:
    """--scan_steps N: chunks of N batches from the stream, stacked on the
    card, one scanned_fused_steps call each; its stacked metrics read once
    and logged per step. Display and save fire once after a chunk inside
    which their cadence's boundary was crossed. A ragged tail is a shorter
    chunk: scanned_fused_steps runs it step by step like any other (the
    JAX CLI runs its tail through fused_gan_step because a shorter lax.scan
    would recompile)."""
    n = args.scan_steps
    while timer.step < total_steps:
        chunk = []
        while len(chunk) < min(n, total_steps - timer.step):
            item = next_timed(it, waits)
            if item is None:
                break
            chunk.append(item[0])
        if not chunk:
            break
        base = timer.step
        with timer(len(chunk)):
            metrics, fake = P.scanned_fused_steps(
                state, {k: torch.stack([c[k] for c in chunk]) for k in chunk[0]}, vgg)
        metrics = {k: v.cpu().numpy() for k, v in sorted(metrics.items())}
        for i in range(len(chunk)):
            row = {k: v[i] for k, v in metrics.items()}
            guard.check(base + i + 1, row)
            logger.log(base + i + 1, row, timer.stats())

        crossed = lambda every: every and (timer.step // every) > (base // every)  # noqa: E731
        if crossed(args.display_every):
            _display(args.out_dir, timer.step, fake, chunk[-1]["warped"])
        if crossed(args.save_every):
            save_train_state(ckpt_dir, state, "latest")
            timer.record()


if __name__ == "__main__":
    main()
