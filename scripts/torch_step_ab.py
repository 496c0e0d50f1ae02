"""Time the port's single-device regression step of two checkouts against
each other on one card, in turns.

    python scripts/torch_step_ab.py --trees A B [--rounds 2] [--iters 25] [--out FILE]

Each tree (the root of a checkout holding ``emlight_tpu_torch``) runs in a
process of its own, in the order A B B A per round, so a drift of the card
or the host shows as a difference between the two runs of one tree. Each
process builds the tree's kernels and times ``regression.train_step`` at
``RegressionConfig()`` (full width, batch 16, one seeded state and batch)
on each route of chip_smoke.py's phase 12b: train_forward "buffer" (the
default, phase 12's step) and "standard", each in float32 and bfloat16.
Per route it prints, as one JSON line: the median step time by CUDA
events, the median host time to return from the call (what Python and the
launches cost before the card is waited for), both over --iters steps
after 3 warm-up steps, and one profiled step's wall and device-busy time
(torch.profiler; busy is the union of the device's kernel and copy
intervals). --out writes every process's rows as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROUTES = (("buffer", "float32"), ("standard", "float32"), ("buffer", "bfloat16"),
          ("standard", "bfloat16"))
BATCH = 16


def _busy_ms(torch, fn) -> tuple[float, float] | None:
    """One fn() under torch.profiler: (wall ms to the last synchronize,
    device-busy ms), or None if it saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return wall, busy / 1e3


def child(tree: str, iters: int, seed: int) -> list[dict]:
    """The rows of one tree, timed in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from emlight_tpu_torch import kernels
    from emlight_tpu_torch.config import RegressionConfig
    from emlight_tpu_torch.train import regression as TR
    from emlight_tpu_torch.train.data import synthetic_regression_batch

    assert TR.__file__.startswith(os.path.abspath(tree)), TR.__file__
    kernels.build()
    dev = torch.device("cuda")
    cfg = RegressionConfig()
    raw = synthetic_regression_batch(BATCH, cfg.anchors.regression_anchors,
                                     (cfg.crop_h, cfg.crop_w), seed=seed + 200)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    rows = []
    for route, dtype in ROUTES:
        state = TR.create_state(dataclasses.replace(cfg, dtype=dtype, train_forward=route),
                                device=dev, seed=seed + 41)
        for _ in range(3):
            TR.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms, host_ms = [], []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            TR.train_step(state, batch)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        prof = _busy_ms(torch, lambda: TR.train_step(state, batch))
        rows.append({"tree": tree, "route": route, "dtype": dtype,
                     "step_ms": statistics.median(step_ms), "step_ms_min": min(step_ms),
                     "step_ms_max": max(step_ms), "host_ms": statistics.median(host_ms),
                     "profiled_wall_ms": prof and prof[0], "busy_ms": prof and prof[1]})
        print(json.dumps(rows[-1]), flush=True)
        del state
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"), required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.iters, args.seed)
        return 0
    a, b = args.trees
    order = [a, b, b, a] * args.rounds
    rows = []
    for i, tree in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--trees", a, b,
                              "--child", tree, "--iters", str(args.iters),
                              "--seed", str(args.seed)],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            raise SystemExit(f"run {i} ({tree}) exited {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                rows.append(dict(json.loads(line), run=i))
                print(json.dumps(rows[-1]), flush=True)
    for route, dtype in ROUTES:
        for tree in (a, b):
            got = [r for r in rows if (r["tree"], r["route"], r["dtype"]) == (tree, route, dtype)]
            print(f"{route} {dtype} {tree}: step ms " + ", ".join(
                f"{r['step_ms']:.3f}" for r in got) + "; host ms " + ", ".join(
                f"{r['host_ms']:.3f}" for r in got) + "; busy ms " + ", ".join(
                f"{r['busy_ms']:.3f}" if r["busy_ms"] is not None else "none" for r in got))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
