"""What the port's CLIs share: the device check, the launch of --parallel's
ranks, the regressor's and projector's configs, the regressor's restore
(.msgpack or reference .pth, in the dtype of the run it came from), the
crop list and the crop preprocessing, dataset items as a batch on the
device, the eval CLIs' report and a training loop's data wait.

--parallel (the five CLIs that have it: train_regression,
train_projector, infer, test_regression, test_projector) runs one rank
per card (``launch``): under torchrun (WORLD_SIZE set) or in a process
group someone else started, each process is one rank of that group;
otherwise the CLI spawns one rank per visible card
(torch.multiprocessing), after building the kernels and the native
library once, and with ``--device cpu`` it runs $EMLIGHT_CPU_RANKS gloo
ranks (default one, in the process itself; more are spawned). NCCL joins
the cards, gloo the CPU ranks (dist/mesh.py::join)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import AnchorConfig, ProjectorConfig, RegressionConfig
from ..core.device import resolve_device
from ..core.hdr import TONEMAP_INPUT, resize_panorama
from ..dist import mesh
from ..train import regression as R
from ..train.checkpoint import load_checked, restore_regressor
from ..train.jax_weights import densenet_state_from_jax
from ..train.torch_import import import_densenet_state_dict

__all__ = ["CPU_RANKS_ENV", "PARALLEL_HELP", "add_device_flag", "checked_device", "rank_count",
           "launch", "spawn_ranks", "regression_config", "saved_dtype", "projector_config",
           "pooled_hw", "load_regressor", "regressor_apply", "crop_names", "tonemapped_crop",
           "stacked", "summary_line", "next_timed"]

# how many gloo ranks --parallel spawns with --device cpu outside torchrun
CPU_RANKS_ENV = "EMLIGHT_CPU_RANKS"
PARALLEL_HELP = ("one rank per card: joins torchrun's group (or the process group already "
                 "started), else spawns one rank per visible card; NCCL between cards; with "
                 f"--device cpu gloo ranks, ${CPU_RANKS_ENV} of them (default 1)")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the kernels' "
                         "plain PyTorch versions)")


def checked_device(ap: argparse.ArgumentParser, argv):
    """First parse of the command line, before any file is read or written:
    a CUDA device that is not there raises."""
    return resolve_device(ap.parse_args(argv).device)


def _joining() -> bool:
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def rank_count(parallel: bool, device) -> int:
    """How many ranks ``launch`` runs: 1 without --parallel; the group's
    size when it joins one; the visible cards when it spawns on CUDA; on
    the CPU, CPU_RANKS_ENV's count (1 when unset)."""
    if not parallel:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get(CPU_RANKS_ENV, 1))


def launch(main, argv, parallel: bool, device, body):
    """Run ``body(device, group)``: with group None without --parallel;
    as one rank of a group with it (``mesh.join``), on the rank's device.
    Where no group is there to join and ``rank_count`` is above 1, the
    ranks are spawned (``spawn_ranks``), each running ``main(argv)`` again
    inside the group, and rank 0's result is returned; a rank that fails
    makes this raise. A collective that waits longer than
    mesh.DIST_TIMEOUT_S fails its rank."""
    if not parallel:
        return body(device, None)
    joining = _joining()
    n = rank_count(True, device)
    if not joining and n > 1:
        return spawn_ranks(main, argv, n, torch.device(device).type)
    # a group to join, or without one a group of one of its own
    store = None if joining else tempfile.mkdtemp(prefix="emlight_dist_")
    group, created = mesh.join(device, store and "file://" + os.path.join(store, "init"))
    try:
        device = mesh.rank_device(device, group)
        mesh.barrier(group)  # every rank has read its flags (and a run's opt.json)
        return body(device, group)
    finally:
        mesh.leave(created)
        if store:
            shutil.rmtree(store, ignore_errors=True)


def spawn_ranks(main, argv, n: int, device_type: str, timeout_s: float = mesh.DIST_TIMEOUT_S,
                deadline_s: float | None = None):
    """Run ``main(argv)`` on `n` spawned ranks of one group (a FileStore in
    a temporary directory; NCCL on rank r's card r for "cuda", gloo for
    "cpu"; `timeout_s` on every collective) and return rank 0's result.
    For cards the kernels and the native library are built here first, so
    the ranks do not each run nvcc. A rank that fails terminates the
    others and raises here. The ranks of one run end together (at their
    last collective), so once one has ended the others get `timeout_s`;
    past that, or past `deadline_s` from the start when given, they are
    killed and this raises."""
    from .. import kernels, native

    if device_type == "cuda":
        kernels.build()
    native.load()
    store = tempfile.mkdtemp(prefix="emlight_dist_")
    start, ctx = time.monotonic(), None
    try:
        ctx = torch.multiprocessing.start_processes(
            _spawned_rank, args=(main, argv, n, store, device_type, timeout_s), nprocs=n,
            join=False, start_method="spawn")
        ended = None
        while not ctx.join(timeout=1.0):  # raises when a rank failed
            now = time.monotonic()
            if ended is None and not all(p.is_alive() for p in ctx.processes):
                ended = now
            if ended is not None and now - ended > timeout_s:
                raise RuntimeError(f"--parallel: a rank still ran {timeout_s} s after another "
                                   "had ended; the ranks were killed")
            if deadline_s is not None and now - start > deadline_s:
                raise RuntimeError(f"--parallel: the ranks ran past {deadline_s} s and were "
                                   "killed")
        with open(os.path.join(store, "result.pickle"), "rb") as f:
            return pickle.load(f)
    finally:
        for p in ctx.processes if ctx else []:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)


def _spawned_rank(index: int, main, argv, n: int, store: str, device_type: str,
                  timeout_s: float) -> None:
    """A spawned rank: joins the group whose store is in `store` as rank
    `index` of `n` (on card `index` for CUDA), runs ``main(argv)`` in it,
    and rank 0 leaves its result there."""
    os.environ.update(RANK=str(index), WORLD_SIZE=str(n), LOCAL_RANK=str(index))
    _, created = mesh.join(torch.device(device_type), "file://" + os.path.join(store, "init"),
                           timeout_s=timeout_s)
    try:
        out = main(argv)
    finally:
        mesh.leave(created)
    if index == 0:
        with open(os.path.join(store, "result.pickle"), "wb") as f:
            pickle.dump(out, f)


def regression_config(anchors: int, crop, block_config, clip_grad_norm: float,
                      **fields) -> RegressionConfig:
    crop_h, crop_w = (int(x) for x in str(crop).split(","))
    return dataclasses.replace(
        RegressionConfig(),
        anchors=AnchorConfig(regression_anchors=anchors),
        crop_h=crop_h,
        crop_w=crop_w,
        block_config=tuple(int(x) for x in str(block_config).split(",")),
        clip_grad_norm=clip_grad_norm,
        **fields,
    )


def saved_dtype(saved: dict | None) -> str:
    """The regressor's compute dtype of the training run whose opt.json
    --load_config named (float32 without one)."""
    return (saved or {}).get("dtype", "float32")


def projector_config(args: argparse.Namespace, **fields) -> ProjectorConfig:
    """The ProjectorConfig of a projector CLI's shape flags (crop_size, ngf,
    ndf, anchors, dtype, clip_grad_norm); env maps are crop_size/2 x
    crop_size."""
    return dataclasses.replace(
        ProjectorConfig(),
        crop_size=args.crop_size, ngf=args.ngf, ndf=args.ndf, dtype=args.dtype,
        clip_grad_norm=args.clip_grad_norm,
        anchors=AnchorConfig(n_anchors=args.anchors, env_h=args.crop_size // 2,
                             env_w=args.crop_size),
        **fields,
    )


def pooled_hw(cfg: RegressionConfig) -> tuple[int, int]:
    """The map the regressor's fc reads: every block's transition halves the
    crop, then the 4x4 average pool."""
    n = 2 ** len(cfg.block_config) * 4
    return cfg.crop_h // n, cfg.crop_w // n


def load_regressor(path: str, cfg: RegressionConfig, device):
    """The regressor from a JAX .msgpack checkpoint or a reference .pth
    (imported at this config's depth and crop), computing in cfg.dtype."""
    model = R.make_model(cfg, device=device)
    if path.endswith(".pth"):
        params, stats = import_densenet_state_dict(path, block_config=cfg.block_config,
                                                   pooled_hw=pooled_hw(cfg))
        return load_checked(model, densenet_state_from_jax(params, stats), path)
    return restore_regressor(path, model)


def regressor_apply(eval_apply: str, cfg: RegressionConfig, regressor):
    """The eval CLIs' forward, ``--eval_apply``: "fast" (the default) the
    concat-free buffer forward, as a closure over this checkpoint
    (regression.make_baked_infer); "standard" the DenseNet module's own.
    Returns apply(crop) -> heads."""
    if eval_apply == "fast":
        return R.make_baked_infer(cfg, regressor)
    return lambda crop: R.predict(regressor, crop)


def crop_names(crops: str | None, data_root: str | None, limit: int) -> tuple[str, list[str]]:
    crop_dir = crops or os.path.join(data_root, "crop")
    names = sorted(n for n in os.listdir(crop_dir) if n.endswith(".exr"))
    return crop_dir, names[:limit] if limit else names


def tonemapped_crop(img: np.ndarray, crop_h: int, crop_w: int) -> tuple[np.ndarray, np.ndarray]:
    """TONEMAP_INPUT of a crop (its alpha cancels end to end), and that
    image at the regressor's crop size (resized where it differs)."""
    img, _ = TONEMAP_INPUT(img)
    reg_in = img
    if reg_in.shape[:2] != (crop_h, crop_w):
        reg_in = resize_panorama(img, (crop_w, crop_h))
    return img, reg_in


def stacked(samples: list[dict], device) -> dict:
    """A list of dataset items as one batch of tensors on `device` (the
    names left out)."""
    return {k: torch.as_tensor(np.stack([smp[k] for smp in samples]), device=device)
            for k in samples[0] if k != "name"}


def summary_line(acc: dict[str, list], count: int, out: str | None, width: int) -> dict:
    """The eval CLIs' report: a table of each metric's mean, median and p90
    over the samples, then ONE JSON line of the same (keys sorted, as the
    JAX CLIs' jitted metric dicts come back), also written to `out` if
    given. Returns the JSON line's dict."""
    summary: dict = {"n_samples": count}
    print(f"\n{'metric':<{width}} {'mean':>10} {'median':>10} {'p90':>10}")
    for k in sorted(acc):
        v = np.concatenate(acc[k])
        summary[k] = {"mean": float(v.mean()), "median": float(np.median(v)),
                      "p90": float(np.percentile(v, 90))}
        print(f"{k:<{width}} {v.mean():>10.4f} {np.median(v):>10.4f} "
              f"{np.percentile(v, 90):>10.4f}")
    line = json.dumps(summary)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return summary


def next_timed(it, waits: list[float]):
    """next(it, None), its wait on the host clock appended to `waits` (a
    training loop's wait on its data queue)."""
    t0 = time.perf_counter()
    item = next(it, None)
    waits.append(time.perf_counter() - t0)
    return item
