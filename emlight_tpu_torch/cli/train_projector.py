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

Without VGG19 weights the JAX CLI trains without the perceptual term, and
so does the port. The flags of what is not ported exit with their
ROADMAP.md §1 item, named by its title: --fused and --scan_steps,
--vgg_npz with a file (or $EMLIGHT_VGG19_NPZ) and --vgg_random ("The rest
of GAN training"), --parallel ("Multi-GPU").

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

from ..core.hdr import TONEMAP_VIZ
from ..core.png import write_png
from ..train import projector as P
from ..train.checkpoint import latest_checkpoint, restore_train_state, save_train_state
from ..train.config_io import apply_saved_defaults, report_overrides, save_run_config
from ..train.data import (ProjectorDataset, batched, device_prefetch, prefetch,
                          synthetic_projector_batch)
from ..train.loop import IterationTimer, MetricsLogger, NaNGuard
from ._common import (GAN_STEP_NOT_PORTED, PARALLEL_NOT_PORTED, VGG_NOT_PORTED,
                      add_device_flag, checked_device, next_timed, projector_config, refuse)


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
    ap.add_argument("--vgg_npz", default=None,
                    help="not ported yet (ROADMAP.md §1, \"The rest of GAN training\"): exits "
                         "when the file exists")
    ap.add_argument("--vgg_random", action="store_true",
                    help="not ported yet (ROADMAP.md §1, \"The rest of GAN training\"): exits")
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
                    help="not ported yet (ROADMAP.md §1, \"The rest of GAN training\"): exits")
    ap.add_argument("--scan_steps", type=int, default=0,
                    help="not ported yet (ROADMAP.md §1, \"The rest of GAN training\"): exits "
                         "when > 1")
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
    # where the JAX CLI would load VGG19 weights (nn/vgg.py::load_vgg19_params)
    vgg_npz = args.vgg_npz or os.environ.get("EMLIGHT_VGG19_NPZ")
    refuse(ap, (args.parallel, PARALLEL_NOT_PORTED),
           (args.fused or args.scan_steps > 1, GAN_STEP_NOT_PORTED),
           (bool(vgg_npz) and os.path.exists(vgg_npz) or args.vgg_random, VGG_NOT_PORTED))
    report_overrides(saved, args)
    save_run_config(args.out_dir, args)

    cfg = projector_config(args, batch_size=args.batch_size, lr=args.lr,
                           gan_mode=args.gan_mode, d_steps_per_g=args.d_steps_per_g)
    env_h, env_w = args.crop_size // 2, args.crop_size
    print("VGG19 weights unavailable -> perceptual term disabled")

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

    it = device_prefetch(batches, dev)
    while timer.step < total_steps:
        item = next_timed(it, waits)
        if item is None:
            break
        tb, _rest = item
        with timer:
            metrics = {}
            # G every d_steps_per_g iterations, D every iteration
            # (train.py:29-37); each step's keys sorted, as the JAX steps
            # return them from jitted functions
            if timer.step % cfg.d_steps_per_g == 0:
                g_metrics, fake = P.generator_step(state, tb)
                metrics.update(sorted(g_metrics.items()))
            metrics.update(sorted(P.discriminator_step(state, tb).items()))
        guard.check(timer.step, metrics)
        logger.log(timer.step, metrics, timer.stats())

        if args.display_every and timer.step % args.display_every == 0 and "loss_G" in metrics:
            tone_f, _ = TONEMAP_VIZ(fake[0].float().cpu().numpy())
            tone_r, _ = TONEMAP_VIZ(tb["warped"][0].float().cpu().numpy())
            os.makedirs(os.path.join(args.out_dir, "web"), exist_ok=True)
            write_png(os.path.join(args.out_dir, "web", f"{timer.step}.png"),
                      (np.hstack([tone_r, tone_f]) * 255).astype(np.uint8))
        if args.save_every and timer.step % args.save_every == 0:
            save_train_state(ckpt_dir, state, "latest")
            timer.record()
    loop_s = time.perf_counter() - t_loop

    save_train_state(ckpt_dir, state, "latest")
    timer.record()
    print(f"done at step {timer.step}; stats {timer.stats()}")
    return {"restored": restored, "start": start, "step": timer.step, "wait_s": waits,
            "loop_s": loop_s, "step_ms": timer.device_ms}


if __name__ == "__main__":
    main()
