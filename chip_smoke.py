#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (emlight_tpu_torch) on one GPU.

Drives the port's main serving path — crop -> DenseNet-BC regressor ->
Gaussian-splat guide -> SPADE generator -> 128x256 HDR env map — at full
width (RegressionConfig() and ProjectorConfig() defaults, weights drawn from
seeded torch.Generators) and holds every hand-written kernel against its
plain PyTorch version. Phases, each of which raises on failure:

1. device   card name and nvidia-smi's name and power limit
2. build    nvcc builds every csrc/*.cu (all started together)
3. check    the sphere-conv kernel vs its plain version on the card at every
            distinct main-path shape, f32 (TF32 off) and bf16, at batch 2
            (and again at the main path's batch in phase 5)
4. slice    4 requests of batch 8 through pipeline_inference, with the
            kernel's launch count read around them (44 per request); env maps
            checked; one batch-1 request compared with the same modules on
            the CPU (plain path)
5. timing   CUDA events, median of 10 after warm-up: per-shape kernel vs
            plain version, regressor, generator and pipeline at batch 8;
            one profiled request: device busy time and the top device work
6. kernels  one JSON line with every ported kernel

The last line of stdout is {"ok": true, "device": {...}}. Without CUDA, or
run from a directory without the package beside it, it exits non-zero and
prints no result.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
LAUNCHES_PER_FORWARD = 44
REQUESTS, BATCH = 4, 8  # the main path: 4 requests of batch 8


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, warmup: int = 2, iters: int = 10) -> float:
    """Median device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(torch, fn, top: int = 8):
    """One run of fn() under torch.profiler: its host wall time to the last
    synchronize (ms), the device's busy time in it (the union of its kernel and
    copy intervals, ms) and the `top` kernels by device time as (name, ms,
    launches). None if the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return None
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in dev_events):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    by_name: dict = {}
    for e in dev_events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall_ms, busy_us / 1e3, [(name, us / 1e3, n) for name, (us, n) in ranked]


def conv_bound_ms(b, h, w, cin, cout, dtype):
    """Least time for one sphere conv: the larger of its operations over the
    card's peak for the type and its bytes (each input read once, the output
    written once) over the memory rate."""
    size = 4 if dtype == "float32" else 2
    flops = 2 * b * h * w * 9 * cin * cout + 8 * b * h * w * 9 * cin
    nbytes = (b * h * w * cin * size + 9 * cin * cout * size + cout * 4
              + h * 36 * 16 + b * h * w * cout * 4)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import emlight_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(emlight_tpu_torch.__file__))) != HERE:
        print("chip_smoke: emlight_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    from emlight_tpu_torch import kernels
    from emlight_tpu_torch.config import ProjectorConfig, RegressionConfig
    from emlight_tpu_torch.nn.sphere_conv import SphereConv2D, sphere_conv_plain
    from emlight_tpu_torch.nn.sphere_conv_kernel import KERNEL_SOURCE, REPLACES, sphere_conv_s1
    from emlight_tpu_torch.train import pipeline as PL
    from emlight_tpu_torch.train import projector as PJ
    from emlight_tpu_torch.train import regression as RG

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(kernels.SOURCES)} kernel source(s) ready in {build_s:.1f} s")
    for name, out in kernels.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")

    reg_cfg, proj_cfg = RegressionConfig(), ProjectorConfig()
    regressor = RG.make_model(reg_cfg, device=dev, seed=args.seed)
    generator = PJ.make_models(proj_cfg, device=dev, seed=args.seed + 1)
    rng = np.random.default_rng(args.seed)

    def crops(b):
        crop_reg = rng.random((b, reg_cfg.crop_h, reg_cfg.crop_w, 3), dtype=np.float32)
        crop_proj = rng.random((b, proj_cfg.crop_size // 2, proj_cfg.crop_size // 2, 3),
                               dtype=np.float32)
        return torch.from_numpy(crop_reg).to(dev), torch.from_numpy(crop_proj).to(dev)

    def request(crop_reg, crop_proj, regressor=regressor, generator=generator, device=dev):
        return PL.pipeline_inference(regressor, generator, crop_reg, crop_proj,
                                     reg_cfg, proj_cfg, device=device)

    # the main path's sphere-conv shapes, recorded by hooks on one warm-up request
    seen: list = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append(tuple(inp[0].shape[1:]) + (mod.kernel.shape[-1],)))
        for m in generator.modules() if isinstance(m, SphereConv2D)]
    request(*crops(1))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if len(seen) != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"generator ran {len(seen)} sphere convs, expected 44")
    shapes = sorted(set(seen))
    per_forward = {s: seen.count(s) for s in shapes}
    log(f"[check] {len(shapes)} distinct sphere-conv shapes (H, W, Cin, Cout) on the main path")

    # 3. kernel check: at batch 2 here, and again at the main path's batch in
    # phase 5, on the inputs it times
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    worst = {"float32": 0.0, "bfloat16": 0.0, "bf16_rel": 0.0}

    def conv_inputs(b, h, w, cin, cout):
        x = torch.rand(b, h, w, cin, device=dev, generator=gen)
        k = torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5
        bias = torch.randn(cout, device=dev, generator=gen) * 0.1
        return x, k, bias

    def check(x, k, bias):
        """Kernel against its plain version on the same inputs, f32 and bf16."""
        for dt in ("float32", "bfloat16"):
            xt, kt = x.to(getattr(torch, dt)), k.to(getattr(torch, dt))
            out = sphere_conv_s1(xt, kt, bias)
            ref = sphere_conv_plain(xt, kt, bias)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if dt == "float32":
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            else:
                scale = ref.abs().max().item()
                if err > 2e-2 * scale:
                    raise AssertionError(f"bf16 kernel error {err} > 2e-2 * {scale} at "
                                         f"{tuple(x.shape)} -> {k.shape[-1]}")
                worst["bf16_rel"] = max(worst["bf16_rel"], err / scale)
            worst[dt] = max(worst[dt], err)

    def report_check(where):
        log(f"[check] kernel vs plain {where}: worst max|err| f32 {worst['float32']:.3e} "
            f"(rtol=atol=1e-4), bf16 {worst['bfloat16']:.3e} "
            f"({worst['bf16_rel']:.3e} of max|ref|, bar 2e-2)")

    for (h, w, cin, cout) in shapes:
        check(*conv_inputs(2, h, w, cin, cout))
    report_check("at batch 2")

    # 4. slice: the main path, with the launch count read around it
    reqs = [crops(BATCH) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    sphere_conv_s1.launches = 0
    unsat = []
    for i, (crop_reg, crop_proj) in enumerate(reqs):
        before = sphere_conv_s1.launches
        env, pred = request(crop_reg, crop_proj)
        torch.cuda.synchronize()
        grew = sphere_conv_s1.launches - before
        if grew != LAUNCHES_PER_FORWARD:
            raise AssertionError(f"request {i}: {grew} kernel launches, expected 44")
        if tuple(env.shape) != (BATCH, 128, 256, 3):
            raise AssertionError(f"env shape {tuple(env.shape)}")
        if not torch.isfinite(env).all():
            raise AssertionError(f"request {i}: non-finite env map")
        if env.min().item() < 0 or env.max().item() > 50:
            raise AssertionError(f"request {i}: env outside [0, 50]")
        if env.std().item() == 0:
            raise AssertionError(f"request {i}: constant env map")
        t = env / 25.0 - 1.0
        unsat.append(((t > -0.99) & (t < 0.99)).float().mean().item())
        for k_, v in pred.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: non-finite {k_}")
    main_launches = sphere_conv_s1.launches
    if main_launches != LAUNCHES_PER_FORWARD * REQUESTS or main_launches == 0:
        raise AssertionError(f"main path launched the kernel {main_launches} times")
    log(f"[slice] {REQUESTS} requests x batch {BATCH}: env (B,128,256,3) finite, "
        f"in [0, 50], not constant; kernel launches {main_launches} "
        f"({LAUNCHES_PER_FORWARD} per request); unsaturated share "
        + ", ".join(f"{u:.4f}" for u in unsat))

    # the same batch-1 request on the card and on the CPU (plain path)
    crop_reg, crop_proj = crops(1)
    env_gpu, pred_gpu = request(crop_reg, crop_proj)
    reg_cpu = copy.deepcopy(regressor).to("cpu")
    gen_cpu = copy.deepcopy(generator).to("cpu")
    t0 = time.perf_counter()
    env_cpu, pred_cpu = request(crop_reg.cpu(), crop_proj.cpu(), reg_cpu, gen_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    del reg_cpu, gen_cpu
    env_err = (env_gpu.cpu() - env_cpu).abs().max().item()
    torch.testing.assert_close(env_gpu.cpu(), env_cpu, rtol=1e-3, atol=1e-2)
    for k_ in pred_cpu:
        torch.testing.assert_close(pred_gpu[k_].cpu(), pred_cpu[k_], rtol=1e-3, atol=1e-4)
    log(f"[slice] batch-1 request, card vs CPU plain path: env max|err| {env_err:.3e} "
        f"(rtol 1e-3, atol 1e-2); CPU took {cpu_s:.1f} s")

    # 5. timing (f32, TF32 off)
    b = BATCH
    rows = []
    for (h, w, cin, cout) in shapes:
        x, k, bias = conv_inputs(b, h, w, cin, cout)
        check(x, k, bias)
        xb, kb = x.bfloat16(), k.bfloat16()
        row = {
            "shape": [b, h, w, cin, cout],
            "per_forward": per_forward[(h, w, cin, cout)],
            "plain_ms": cuda_ms(torch, lambda: sphere_conv_plain(x, k, bias)),
            "ms": cuda_ms(torch, lambda: sphere_conv_s1(x, k, bias)),
            "bf16_ms": cuda_ms(torch, lambda: sphere_conv_s1(xb, kb, bias)),
        }
        row["bound_ms"], row["bound_by"] = conv_bound_ms(b, h, w, cin, cout, "float32")
        row["bf16_bound_ms"], _ = conv_bound_ms(b, h, w, cin, cout, "bfloat16")
        rows.append(row)
        log(f"[timing] sphere_conv_s1 B{b} {h}x{w} {cin}->{cout} x{row['per_forward']}: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), bf16 kernel "
            f"{row['bf16_ms']:.4f} ms (bound {row['bf16_bound_ms']:.4f})")
    del x, k, xb, kb
    report_check(f"at batches 2 and {b}")
    total = {key: sum(r[key] * r["per_forward"] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "bf16_ms", "bf16_bound_ms")}
    ops_ms = sum(r["bound_ms"] * r["per_forward"] for r in rows if r["bound_by"] == "operations")
    total_bound_by = "operations" if ops_ms >= total["bound_ms"] / 2 else "bytes"

    crop_reg, crop_proj = crops(b)
    guide = PL.predicted_guide(RG.predict(regressor, crop_reg), 128, 256,
                               proj_cfg.anchors.splat_size)
    with torch.inference_mode():
        reg_ms = cuda_ms(torch, lambda: regressor(crop_reg))
        gen_ms = cuda_ms(torch, lambda: generator(guide, crop_proj))
    pipe_ms = cuda_ms(torch, lambda: request(crop_reg, crop_proj))
    log(f"[timing] batch {b}: regressor {reg_ms:.3f} ms, generator {gen_ms:.3f} ms, "
        f"pipeline_inference {pipe_ms:.3f} ms; the generator's 44 sphere convs: kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms ({total_bound_by})")

    # where the time of one request goes, by the profiler's device trace
    prof = device_profile(torch, lambda: request(crop_reg, crop_proj))
    if prof is None:
        log("[profile] the profiler saw no device work: busy share not measured")
    else:
        wall_ms, busy_ms, ranked = prof
        log(f"[profile] one batch-{b} request under the profiler: {wall_ms:.3f} ms, device "
            f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top device work:")
        for name, ms, n in ranked:
            log(f"[profile]   {ms:9.3f} ms  {ms / busy_ms:.4f}  x{n:<4d} {name[:100]}")

    # 6. kernels line
    kernels_line = {"kernels": [{
        "name": "sphere_conv_s1",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches,
        "max_abs_err": worst["float32"],
        "max_err_f32": worst["float32"],
        "max_err_bf16": worst["bfloat16"],
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": total_bound_by,
        "library_ms": None,
    }]}
    log(smi)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
