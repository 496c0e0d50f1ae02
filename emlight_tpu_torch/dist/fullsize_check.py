"""Full-size fused G+D step over a (data, model) grid of ranks.

Port of emlight_tpu/dist/fullsize_check.py. Builds the flagship
configuration (crop_size 256 -> 128x256 env maps, ngf = ndf = 64, batch 8,
128 anchors, no VGG term: train_laval.sh's architecture), places a rank's
train state on a dp(N/T) x tpT grid (dist/auto.py) and runs one fused G+D
step, then a second one timed; prints one JSON line with the grid, the
platform and the collective backend, the sizes, init_s, first_step_s (the
JAX check's compile_s: the port builds its kernels before the ranks
start), step_s, loss_G and loss_D of the first step and the rank's peak
memory, and raises unless both steps' losses are finite.

    python -m emlight_tpu_torch.dist.fullsize_check [--devices 8] [--tp 2] [--batch 8] \\
        [--crop_size 256] [--ngf 64] [--json FILE] [--device cuda|cpu]

One rank per card over NCCL (cli/_common.py::spawn_ranks; raises when
fewer cards are visible than --devices), or --devices gloo ranks on the
CPU with --device cpu (the JAX check's virtual CPU mesh); --devices 1
runs in this process, without a group. ``run_rank`` is the rank's body,
for callers that have started their ranks already.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import resource
import sys
import time

import torch
import torch.distributed as dist

from ..config import AnchorConfig, ProjectorConfig
from ..core.device import resolve_device
from ..train import projector as P
from ..train.data import synthetic_projector_batch
from . import mesh
from .auto import auto_shard_batch, auto_shard_state, make_auto_projector_steps

__all__ = ["fullsize_config", "run_rank", "main"]


def fullsize_config(crop_size: int = 256, ngf: int = 64, batch: int = 8,
                    anchors: int = 128) -> ProjectorConfig:
    """ProjectorConfig() at crop_size (crop_size/2 x crop_size env maps),
    ngf = ndf, the batch and the anchors, without the VGG term."""
    return dataclasses.replace(
        ProjectorConfig(), crop_size=crop_size, ngf=ngf, ndf=ngf, batch_size=batch,
        anchors=AnchorConfig(n_anchors=anchors, env_h=crop_size // 2, env_w=crop_size),
        use_vgg_loss=False)


def _peak_memory(device: torch.device) -> tuple[float, str]:
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 2**30, "max_memory_allocated"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, "max RSS"


def run_rank(group: mesh.RankGroup | None, device: torch.device, tp: int = 2, batch: int = 8,
             crop_size: int = 256, ngf: int = 64, anchors: int = 128, seed: int = 0) -> dict:
    """One rank's check: its state (``create_state(cfg, device, seed,
    group=grid.data)`` placed on the (size/tp, tp) grid of ``group``) takes
    two fused steps on its data rows of one synthetic batch; returns the
    report (see the module docstring). Every rank of ``group`` calls it
    together (``make_mesh`` creates the grid's groups). Raises unless the
    losses are finite."""
    grid = mesh.make_mesh(group, tp)
    cfg = fullsize_config(crop_size, ngf, batch, anchors)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = auto_shard_state(P.create_state(cfg, device, seed, group=grid.data), grid)
    sync()
    init_s = time.perf_counter() - t0
    _, _, fused = make_auto_projector_steps(cfg, grid)
    whole = synthetic_projector_batch(batch, n_anchors=anchors, crop_size=crop_size // 2,
                                      env_hw=(crop_size // 2, crop_size), seed=seed)
    rows = {k: torch.as_tensor(v, device=device)
            for k, v in auto_shard_batch(whole, grid).items()}
    seconds, losses = [], []
    for _ in range(2):
        mesh.barrier(grid.world)
        t0 = time.perf_counter()
        metrics, _ = fused(state, rows)
        sync()
        seconds.append(time.perf_counter() - t0)
        losses.append((metrics["loss_G"].item(), metrics["loss_D"].item()))
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise FloatingPointError(f"non-finite losses (loss_G, loss_D) by step: {losses}")
    peak, peak_of = _peak_memory(device)
    dp = 1 if grid.data is None else grid.data.size
    return {
        "mesh": f"dp{dp} x tp{tp}",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "backend": None if group is None else dist.get_backend(group.pg),
        "crop_size": crop_size,
        "ngf": ngf,
        "batch": batch,
        "init_s": init_s,
        "first_step_s": seconds[0],
        "step_s": seconds[1],
        "loss_G": losses[0][0],
        "loss_D": losses[0][1],
        "peak_memory_gib": peak,
        "peak_memory_of": peak_of,
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="ranks: cards, or CPU ranks")
    ap.add_argument("--tp", type=int, default=2, help="model-parallel ranks of the grid")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one rank per card, NCCL) or cpu (gloo ranks)")
    return ap


def _check_ranks(args, device: torch.device) -> None:
    """The grid must divide, and on CUDA the cards must be there: the ranks
    never move to the CPU on their own."""
    if args.devices < 1 or args.devices % args.tp:
        raise ValueError(f"--devices {args.devices} does not divide by --tp {args.tp}")
    if device.type == "cuda" and torch.cuda.device_count() < args.devices:
        raise RuntimeError(f"--devices {args.devices}: {torch.cuda.device_count()} card(s) "
                           "visible; --device cpu runs gloo ranks on the CPU")


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    sizes = dict(tp=args.tp, batch=args.batch, crop_size=args.crop_size, ngf=args.ngf)
    if dist.is_initialized():  # a rank spawn_ranks started
        group, _ = mesh.join(torch.device(args.device))
        if args.device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // group.size))
        return run_rank(group, mesh.rank_device(args.device, group), **sizes)
    from ..cli._common import spawn_ranks

    device = resolve_device(args.device)
    _check_ranks(args, device)
    if args.devices == 1:
        result = run_rank(None, device, **sizes)
    else:
        result = spawn_ranks(main, argv, args.devices, device.type)
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
