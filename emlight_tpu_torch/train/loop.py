"""Training-loop services: metrics, timing, failure detection, summaries,
profiling.

The port's own copy of emlight_tpu/train/loop.py:

- ``MetricsLogger``: metrics.csv, the same columns in the same order;
- ``IterationTimer``: iter.json bookmarks (resume, record) and per-step
  wall time. On the card a step returns before its kernels finish, so the
  timer synchronizes the device at the step's end (``__exit__``), and
  keeps each step's device time from CUDA events;
- ``NaNGuard``: raises when a metric goes non-finite;
- ``render_summary``: a crop | GT env | pred env strip, rasterized with the
  port's splat and written as PNG (core/png.py) where the JAX package
  writes JPEG through PIL; the 256x256 resize is the port's INTER_AREA
  (core/hdr.py::resize_panorama), not PIL's;
- ``profile_trace``: ``torch.profiler`` over a block, its Chrome trace
  written into a directory.

In data-parallel training every rank runs the loop on the metrics averaged
over the ranks (so ``NaNGuard`` stops every rank at the same step), and
only rank 0 writes: the logger and the timer of the others are built
with ``writer=False``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from ..core.hdr import TONEMAP_VIZ, resize_panorama
from ..core.png import write_png
from ..representation.splat import render_anchor_params

__all__ = ["MetricsLogger", "IterationTimer", "NaNGuard", "summary_arrays", "render_summary",
           "profile_trace"]


class MetricsLogger:
    """Append metric dicts to CSV and (optionally) stdout; with
    writer=False (a rank but the first) neither."""

    def __init__(self, out_dir: str, name: str = "metrics", echo_every: int = 10,
                 writer: bool = True):
        self.writer = writer
        if writer:
            os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.csv")
        self.echo_every = echo_every
        self._keys: list[str] | None = None
        self._n = 0

    def log(self, step: int, metrics: dict, extra: dict | None = None) -> None:
        if not self.writer:
            return
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if extra:
            row.update(extra)
        if self._keys is None:
            self._keys = list(row)
            if not os.path.exists(self.path):
                with open(self.path, "a") as f:
                    f.write(",".join(self._keys) + "\n")
        with open(self.path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")
        self._n += 1
        if self.echo_every and self._n % self.echo_every == 0:
            parts = ", ".join(f"{k}: {v:.5g}" for k, v in row.items() if k != "step")
            print(f"step {step}: {parts}", flush=True)


class IterationTimer:
    """Tracks epoch/iteration and per-iteration wall time; persists a
    bookmark (iter.json) for --resume.

    ``device``: the device the steps run on. On CUDA, ``__exit__``
    synchronizes it before it reads the clock: a step only enqueues its
    kernels, and without the synchronization the timer would measure the
    launches. There it also keeps each step's device time (CUDA events
    around the step) in ``device_ms``. ``with timer(n):`` times n
    iterations that run as one block (--scan_steps): each is accounted the
    block's time / n, as the JAX timer's ``add``. ``writer=False`` (a rank
    but the first): ``record`` writes nothing.
    """

    def __init__(self, out_dir: str, batch_size: int = 1, device=None, writer: bool = True):
        self.path = os.path.join(out_dir, "iter.json")
        self.writer = writer
        self.batch_size = batch_size
        self.sync = torch.device(device).type == "cuda" if device is not None else False
        self.epoch = 0
        self.step = 0
        self.device_ms: list[float] = []
        self._times: list[float] = []
        self._t0: float | None = None
        self._events = None
        self._n = 1

    def resume(self) -> "IterationTimer":
        if os.path.exists(self.path):
            with open(self.path) as f:
                state = json.load(f)
            self.epoch, self.step = state["epoch"], state["step"]
            print(f"resuming from epoch {self.epoch}, step {self.step}")
        return self

    def record(self) -> None:
        if not self.writer:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"epoch": self.epoch, "step": self.step}, f)

    def __call__(self, n: int) -> "IterationTimer":
        self._n = n
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.sync:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        n, self._n = self._n, 1
        if self.sync:  # the step's end on the device, not its last launch
            self._events[1].record()
            torch.cuda.synchronize()
            self.device_ms.extend([self._events[0].elapsed_time(self._events[1]) / n] * n)
        self._times.extend([(time.perf_counter() - self._t0) / n] * n)
        self.step += n
        if len(self._times) > 200:
            self._times = self._times[-200:]

    def stats(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "time_per_iter": float(arr.mean()),
            "time_per_item": float(arr.mean() / self.batch_size),
            "iter_p50_s": float(np.percentile(arr, 50)),
            "iter_p90_s": float(np.percentile(arr, 90)),
        }


class NaNGuard:
    """Raises (with context) when any metric goes non-finite."""

    def __init__(self, patience: int = 0):
        self.patience = patience
        self._bad = 0

    def check(self, step: int, metrics: dict) -> None:
        bad = {k: float(v) for k, v in metrics.items() if not np.isfinite(float(v))}
        if bad:
            self._bad += 1
            if self._bad > self.patience:
                raise FloatingPointError(f"non-finite metrics at step {step}: {bad}")
        else:
            self._bad = 0


def summary_arrays(crop, dist_pred, dist_gt, intensity_pred, intensity_gt, rgb_pred, rgb_gt,
                   n_anchors: int, intensity_scale: float = 500.0):
    """The summary's three panels before the resize: the crop clipped to
    [0, 1], and the GT and predicted env maps (128x256, the splat of the
    anchor parameters, clipped at 0) as float arrays."""
    def env_of(dist, inten, rgb):
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
        env = render_anchor_params(f32(dist)[None], f32(np.atleast_1d(inten)), f32(rgb)[None],
                                   n=n_anchors, intensity_scale=intensity_scale)
        # untrained nets can predict negative energies; clip before the
        # gamma power (np.power(neg, 1/2.4) is NaN)
        return np.maximum(env.numpy()[0], 0.0)

    return (np.clip(np.asarray(crop, np.float32), 0, 1),
            env_of(dist_gt, intensity_gt, rgb_gt), env_of(dist_pred, intensity_pred, rgb_pred))


def render_summary(crop, dist_pred, dist_gt, intensity_pred, intensity_gt,
                   rgb_pred, rgb_gt, n_anchors: int, out_path: str,
                   intensity_scale: float = 500.0) -> None:
    """crop | GT env | pred env comparison strip, each panel 256x256, as a
    PNG at `out_path`."""
    crop, env_gt, env_pred = summary_arrays(crop, dist_pred, dist_gt, intensity_pred,
                                            intensity_gt, rgb_pred, rgb_gt, n_anchors,
                                            intensity_scale)
    panels = [crop, TONEMAP_VIZ(env_gt)[0], TONEMAP_VIZ(env_pred)[0]]
    strip = np.hstack([(resize_panorama(p, (256, 256)) * 255).astype(np.uint8) for p in panels])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, strip)


@contextlib.contextmanager
def profile_trace(out_dir: str | None):
    """torch.profiler over the block (CPU, and CUDA where there is a card),
    its Chrome trace written to {out_dir}/trace.json; a no-op when out_dir
    is None."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
