#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (emlight_tpu_torch) on one GPU.

Drives the port's two main paths at full width (RegressionConfig() and
ProjectorConfig() defaults, weights drawn from seeded torch.Generators):
serving — crop -> DenseNet-BC regressor -> Gaussian-splat guide -> SPADE
generator -> 128x256 HDR env map — and SPADE GAN training — alternating
generator and discriminator steps at batch 8 — and holds every hand-written
kernel against its plain PyTorch version. Phases, each of which raises on
failure:

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
6. train    3 alternating generator + discriminator steps of batch 8
            (create_state, ProjectorConfig(), VGG off), every kernel's launch
            count read around each step; losses finite, parameters, D's u and
            G's BatchNorm statistics changed
7. tcheck   every training kernel (B2 forward, B3/B5 dx, B4 dK) vs its plain
            version at every distinct training shape, f32 and bf16, at batch
            2 and at the main path's batch (the timed inputs)
8. ttiming  per-shape kernel vs plain version vs bound; the G step and the D
            step at batch 8; one profiled G step: idle share, top device work
9. tcpu     one G step and one D step at batch 2 on a reduced config, card
            against the CPU plain path: losses, and every gradient leaf
            within a bar measured from the CPU's own spread under a jitter
10. kernels one JSON line with every ported kernel

The last line of stdout is {"ok": true, "device": {...}}. Without CUDA, or
run from a directory without the package beside it, it exits non-zero and
prints no result. --out writes the per-shape tables as JSON.

    python3 chip_smoke.py [--seed 0] [--out FILE]
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
TRAIN_STEPS = 3         # the training path: 3 alternating G + D steps of batch BATCH
# kernel launches per step at num_d 2, n_layers_d 4 (D runs on 2B): the G
# step skips dx of the 7 mlp_shared convs (constant guide) and dK of the
# frozen D; the D step runs G without grad and needs no dx into D's input
EXPECTED_G_STEP = {"sphere_conv_s1": 48, "sphere_conv_s2": 6, "sphere_conv_dx_s1": 41,
                   "sphere_conv_dk": 44, "sphere_conv_dx_s2": 6}
EXPECTED_D_STEP = {"sphere_conv_s1": 48, "sphere_conv_s2": 6, "sphere_conv_dx_s1": 4,
                   "sphere_conv_dk": 10, "sphere_conv_dx_s2": 4}
# card vs CPU gradients (phase 9): each leaf within the larger of GRAD_REL and
# GRAD_SPREAD times the CPU's own spread, the change a JITTER-relative
# perturbation of the batch makes to the CPU's gradients (see grad_ratios)
GRAD_REL, GRAD_FLOOR, GRAD_SPREAD, JITTER = 1e-3, 1e-3, 4.0, 1e-6


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


def kernel_bound_ms(kind, b, h, w, cin, cout, stride, dtype, fanin=64):
    """Least time for one launch of a training kernel at input x (b, h, w,
    cin) and output channels cout: the larger of its operations (for fwd, dx
    and dK alike 2*B*Ho*Wo*9*Cin*Cout + 8*B*Ho*Wo*9*Cin) over the card's peak
    for the type and its bytes (inputs, tables and output once) over the
    memory rate. Returns (ms, "operations" or "bytes")."""
    size = 4 if dtype == "float32" else 2
    ho, wo = h // stride, w // stride
    flops = 2 * b * ho * wo * 9 * cin * cout + 8 * b * ho * wo * 9 * cin
    x_b, g_b, k_b = b * h * w * cin * size, b * ho * wo * cout * size, 9 * cin * cout * size
    fwd_tables = ho * 36 * 16
    nbytes = {
        "fwd": x_b + k_b + cout * 4 + fwd_tables + b * ho * wo * cout * 4,
        "dx": g_b + k_b + h * fanin * 20 + b * h * w * cin * 4,
        "dk": x_b + g_b + fwd_tables + 9 * cin * cout * 4,
    }[kind]
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def grad_ratios(port: dict, ref: dict) -> list:
    """(err / scale, leaf) for every gradient leaf, worst last: err the
    leaf's max|port - ref|, scale its own largest magnitude, but never less
    than GRAD_FLOOR of the model's largest gradient (leaves that are zero in
    exact arithmetic hold only rounding noise: a conv bias before a batch
    norm)."""
    model_scale = max(r.abs().max().item() for r in ref.values())
    return sorted(((port[n] - r).abs().max().item()
                   / max(r.abs().max().item(), GRAD_FLOOR * model_scale), n)
                  for n, r in ref.items())


def run_training(torch, np, dev, seed: int, tables: dict, save) -> dict:
    """Phases 6-8: the training path at full width (ProjectorConfig()), its
    kernels against their plain versions and the timings. Calls save() once
    the timing tables are in `tables`. Returns the kernels-line entries of
    B2-B5 and B1's training launches."""
    from emlight_tpu_torch.config import ProjectorConfig
    from emlight_tpu_torch.nn import sphere_conv_kernel as SK
    from emlight_tpu_torch.nn.sphere_conv import SphereConv2D, sphere_conv_plain
    from emlight_tpu_torch.nn.sphere_conv_vjp import dk_plain, dx_plain, inverse_tables
    from emlight_tpu_torch.train import projector as TP
    from emlight_tpu_torch.train.data import synthetic_projector_batch

    names = list(EXPECTED_G_STEP)
    wrappers = {n: getattr(SK, n) for n in names}
    cfg = ProjectorConfig()
    env_hw = (cfg.crop_size // 2, cfg.crop_size)

    def make_batch(s):
        b = synthetic_projector_batch(BATCH, n_anchors=cfg.anchors.n_anchors,
                                      crop_size=cfg.crop_size // 2, env_hw=env_hw, seed=s)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    # 6. the training path: counts set to 0 just before each step, read after
    state = TP.create_state(cfg, device=dev, seed=seed + 10)
    log(f"[train] create_state: G {sum(p.numel() for p in state.g.parameters())} and D "
        f"{sum(p.numel() for p in state.d.parameters())} parameters, batch {BATCH}, "
        f"env {env_hw[0]}x{env_hw[1]}, ngf {cfg.ngf} ndf {cfg.ndf} num_d {cfg.num_d}")
    batches = [make_batch(seed + 100 + i) for i in range(TRAIN_STEPS)]
    calls = {"G": [], "D": []}  # (kind, shape) of every kernel launch, step 1
    record = [None]

    def pre_hook(mod, inp):
        if record[0] is None:
            return
        x = inp[0]
        b, h, w, cin = x.shape
        shape = (b, h, w, cin, mod.kernel.shape[-1], mod.stride)
        grad = torch.is_grad_enabled()
        calls[record[0]].append(("fwd", shape))
        if grad and x.requires_grad:
            calls[record[0]].append(("dx", shape))
        if grad and mod.kernel.requires_grad:
            calls[record[0]].append(("dk", shape))

    hooks = [m.register_forward_pre_hook(pre_hook) for net in (state.g, state.d)
             for m in net.modules() if isinstance(m, SphereConv2D)]
    totals = dict.fromkeys(names, 0)
    for step in range(TRAIN_STEPS):
        g_before = [p.detach().clone() for p in state.g.parameters()]
        d_before = [p.detach().clone() for p in state.d.parameters()]
        u_before = [b_.clone() for n, b_ in state.d.named_buffers() if n.endswith(".u")]
        record[0] = "G" if step == 0 else None
        for w_ in wrappers.values():
            w_.launches = 0
        g_losses, fake = TP.generator_step(state, batches[step])
        torch.cuda.synchronize()
        got = {n: wrappers[n].launches for n in names}
        if got != EXPECTED_G_STEP:
            raise AssertionError(f"G step {step}: launches {got}, expected {EXPECTED_G_STEP}")
        for n in names:
            totals[n] += got[n]
        u_after = [b_ for n, b_ in state.d.named_buffers() if n.endswith(".u")]
        if any(torch.equal(a, b_) for a, b_ in zip(u_before, u_after)):
            raise AssertionError(f"G step {step}: a D spectral u did not change")
        bn_before = [b_.clone() for n, b_ in state.g.named_buffers()
                     if n.endswith((".mean", ".var"))]
        record[0] = "D" if step == 0 else None
        for w_ in wrappers.values():
            w_.launches = 0
        d_losses = TP.discriminator_step(state, batches[step])
        torch.cuda.synchronize()
        got = {n: wrappers[n].launches for n in names}
        if got != EXPECTED_D_STEP:
            raise AssertionError(f"D step {step}: launches {got}, expected {EXPECTED_D_STEP}")
        for n in names:
            totals[n] += got[n]
        bn_after = [b_ for n, b_ in state.g.named_buffers() if n.endswith((".mean", ".var"))]
        if any(torch.equal(a, b_) for a, b_ in zip(bn_before, bn_after)):
            raise AssertionError(f"D step {step}: a G BatchNorm statistic did not change")
        losses = {**g_losses, **d_losses}
        bad = [k for k, v in losses.items() if not torch.isfinite(v)]
        if bad or not torch.isfinite(fake).all():
            raise AssertionError(f"step {step}: non-finite {bad or 'fake'}")
        g_moved = sum(not torch.equal(a, p) for a, p in zip(g_before, state.g.parameters()))
        d_moved = sum(not torch.equal(a, p) for a, p in zip(d_before, state.d.parameters()))
        if g_moved == 0 or d_moved == 0:
            raise AssertionError(f"step {step}: {g_moved}/{len(g_before)} G and "
                                 f"{d_moved}/{len(d_before)} D parameters moved")
        log(f"[train] step {step}: " + ", ".join(f"{k} {v.item():.5g}" for k, v in losses.items())
            + f"; parameters moved G {g_moved}/{len(g_before)}, D {d_moved}/{len(d_before)}")
    for h_ in hooks:
        h_.remove()
    del g_before, d_before
    log(f"[train] {TRAIN_STEPS} G+D steps, kernel launches {totals}: per G step "
        f"{EXPECTED_G_STEP}, per D step {EXPECTED_D_STEP}; D's u moved in every G step, "
        f"G's BatchNorm statistics in every D step")

    # the launches the hooks saw, by kernel and shape, per G and per D step
    def kernel_of(kind, stride):
        return {"fwd": f"sphere_conv_s{stride}", "dx": f"sphere_conv_dx_s{stride}",
                "dk": "sphere_conv_dk"}[kind]

    per_step: dict = {}
    for step_name, seen in calls.items():
        for kind, shape in seen:
            key = (kernel_of(kind, shape[-1]), kind, shape)
            per_step.setdefault(key, {"G": 0, "D": 0})[step_name] += 1
    for step_name, expected in (("G", EXPECTED_G_STEP), ("D", EXPECTED_D_STEP)):
        for n in names:
            seen_n = sum(v[step_name] for k, v in per_step.items() if k[0] == n)
            if seen_n != expected[n]:
                raise AssertionError(f"hooks saw {seen_n} {n} in the {step_name} step, "
                                     f"the counter {expected[n]}")

    # 7. every training kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    worst = {n: {"float32": 0.0, "bf16_rel": 0.0} for n in names}

    def kernel_inputs(kind, b, h, w, cin, cout, stride):
        x = torch.rand(b, h, w, cin, device=dev, generator=gen)
        k = torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5
        bias = torch.randn(cout, device=dev, generator=gen) * 0.1
        g = torch.randn(b, h // stride, w // stride, cout, device=dev, generator=gen)
        if kind == "dk":
            # the cotangent of a loss averaged over the output pixels, so dK
            # stays O(1) however many pixels it sums over (atol 1e-4 holds)
            g /= (b * (h // stride) * (w // stride)) ** 0.5
        return x, k, bias, g

    def run_pair(name, kind, stride, x, k, bias, g):
        """(kernel call, plain call) on the same inputs."""
        xs = tuple(x.shape)
        if kind == "fwd":
            return (lambda: wrappers[name](x, k, bias),
                    lambda: sphere_conv_plain(x, k, bias, stride))
        if kind == "dx":
            return (lambda: wrappers[name](g, k, xs), lambda: dx_plain(g, k, xs, stride))
        return lambda: SK.sphere_conv_dk(x, g, stride), lambda: dk_plain(x, g, stride)

    def check(name, kind, shape, inputs):
        stride = shape[-1]
        for dt in ("float32", "bfloat16"):
            cast = [t.to(getattr(torch, dt)) if t is not None and i != 2 else t
                    for i, t in enumerate(inputs)]
            kern, plain = run_pair(name, kind, stride, *cast)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if dt == "float32":
                rtol, atol = (1e-3, 1e-4) if kind == "dk" else (1e-4, 1e-4)
                torch.testing.assert_close(out, ref, rtol=rtol, atol=atol,
                                           msg=lambda m: f"{name} {shape}: {m}")
                worst[name]["float32"] = max(worst[name]["float32"], err)
            else:
                scale = ref.abs().max().item()
                if err > 2e-2 * scale:
                    raise AssertionError(f"{name} bf16 {shape}: {err} > 2e-2 * {scale}")
                worst[name]["bf16_rel"] = max(worst[name]["bf16_rel"], err / scale)

    train_shapes = sorted(per_step)
    for name, kind, shape in train_shapes:
        check(name, kind, shape, kernel_inputs(kind, 2, *shape[1:]))
    log(f"[tcheck] {len(train_shapes)} (kernel, shape) pairs of the training path; "
        f"at batch 2 every training kernel matches its plain version")

    # 8. timing at the main path's batch (and the batch-8 check on the timed inputs)
    rows = []
    for name, kind, shape in train_shapes:
        b, h, w, cin, cout, stride = shape
        inputs = kernel_inputs(kind, *shape)
        check(name, kind, shape, inputs)
        kern, plain = run_pair(name, kind, stride, *inputs)
        fanin = inverse_tables(h, w, stride)[-1] if kind == "dx" else 64
        bound, bound_by = kernel_bound_ms(kind, b, h, w, cin, cout, stride, "float32", fanin)
        row = {"kernel": name, "kind": kind, "shape": list(shape),
               "per_g_step": per_step[(name, kind, shape)]["G"],
               "per_d_step": per_step[(name, kind, shape)]["D"],
               "ms": cuda_ms(torch, kern, warmup=1, iters=5),
               "plain_ms": cuda_ms(torch, plain, warmup=1, iters=5),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        log(f"[ttiming] {name} {kind} B{b} {h}x{w} {cin}->{cout} s{stride} "
            f"x{row['per_g_step']}/G x{row['per_d_step']}/D: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        del inputs, kern, plain
    tables["train_shapes"] = rows
    log("[tcheck] at batches 2 and the main path's: " + "; ".join(
        f"{n} f32 max|err| {worst[n]['float32']:.3e}, bf16 {worst[n]['bf16_rel']:.3e} of max|ref|"
        for n in names))

    step_ms = {}
    for what, fn in (("G", lambda: TP.generator_step(state, batches[0])),
                     ("D", lambda: TP.discriminator_step(state, batches[0]))):
        step_ms[what] = cuda_ms(torch, fn, warmup=1, iters=5)
    per_kernel = {}
    for n in names:
        sel = [r for r in rows if r["kernel"] == n]
        per = {key: sum(r[key] * (r["per_g_step"] + r["per_d_step"]) for r in sel)
               for key in ("ms", "plain_ms", "bound_ms")}
        ops = sum(r["bound_ms"] * (r["per_g_step"] + r["per_d_step"]) for r in sel
                  if r["bound_by"] == "operations")
        per["bound_by"] = "operations" if ops >= per["bound_ms"] / 2 else "bytes"
        per_kernel[n] = per
    log(f"[ttiming] batch {BATCH}: generator_step {step_ms['G']:.3f} ms, discriminator_step "
        f"{step_ms['D']:.3f} ms; per G+D step: " + "; ".join(
            f"{n} kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.3f}"
            for n, v in per_kernel.items()))
    by_map: dict = {}
    for r in rows:
        n = r["per_g_step"] + r["per_d_step"]
        agg = by_map.setdefault((r["kernel"], r["shape"][1], r["shape"][2]),
                                {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0})
        agg["launches"] += n
        for key in ("ms", "plain_ms", "bound_ms"):
            agg[key] += r[key] * n
    for (n, h, w), v in sorted(by_map.items()):
        log(f"[ttiming] by map, per G+D step: {n} {h}x{w} x{v['launches']}: kernel "
            f"{v['ms']:.3f} ms, plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.4f}")
    tables["train_steps_ms"] = step_ms
    tables["train_per_kernel"] = per_kernel

    prof = device_profile(torch, lambda: TP.generator_step(state, batches[0]), top=10)
    if prof is None:
        log("[ttiming] the profiler saw no device work: idle share not measured")
    else:
        wall_ms, busy_ms, ranked = prof
        log(f"[ttiming] one G step under the profiler: {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top device work:")
        for name, ms, n in ranked:
            log(f"[ttiming]   {ms:9.3f} ms  {ms / busy_ms:.4f}  x{n:<4d} {name[:100]}")
        tables["train_g_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                                     "top": [list(r) for r in ranked]}

    save()

    entries = []
    for n in names[1:]:
        kid, source, replaces = SK.KERNELS[n]
        v = per_kernel[n]
        entries.append({
            "name": n, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
            "launches": totals[n], "max_abs_err": worst[n]["float32"],
            "max_err_f32": worst[n]["float32"], "max_err_bf16_rel": worst[n]["bf16_rel"],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": None,
        })
    return {"entries": entries, "b1_train_launches": totals["sphere_conv_s1"]}



def run_card_vs_cpu(torch, np, dev, seed: int) -> None:
    """Phase 9: one G step and one D step at batch 2 on a reduced config,
    on the card and on the CPU plain path from one state (the D step starts
    from the card's state after its G step); losses and every gradient leaf
    compared.

    The gradient bar is measured, not guessed: the G step's gradients are
    piecewise smooth (lrelu, ReLU, L1 and hinge kinks), and at this config a
    change of the inputs by a few f32 ulps can move a leaf by 1e-3 or more.
    So the CPU runs the steps a second time on a batch whose crop and target
    are jittered by JITTER relative, which moves the generated map further
    than the card's rounding does (both printed), and each leaf of the card
    must lie within GRAD_SPREAD times the largest change that jitter makes,
    and never needs to lie closer than GRAD_REL."""
    import dataclasses

    from emlight_tpu_torch.config import AnchorConfig, ProjectorConfig
    from emlight_tpu_torch.train import projector as TP
    from emlight_tpu_torch.train.data import synthetic_projector_batch

    small = dataclasses.replace(ProjectorConfig(), ngf=16, ndf=16, crop_size=128,
                                anchors=dataclasses.replace(AnchorConfig(), env_h=64, env_w=128))
    sb = synthetic_projector_batch(2, n_anchors=small.anchors.n_anchors, crop_size=64,
                                   env_hw=(64, 128), seed=seed + 30)
    rng = np.random.default_rng(seed + 31)
    jittered = {k: (v * (1 + JITTER * rng.standard_normal(v.shape))).astype(np.float32)
                if k in ("crop", "warped") else v for k, v in sb.items()}
    t0 = time.perf_counter()
    runs = {"card": (dev, sb), "cpu": ("cpu", sb), "cpu jittered": ("cpu", jittered)}
    states = {name: TP.create_state(small, device=d, seed=seed + 20) for name, (d, _) in runs.items()}
    losses, grads, fakes = {}, {}, {}
    for name, st in states.items():
        lg, fake = TP.generator_step(st, runs[name][1])
        losses[name] = {k: v.item() for k, v in lg.items()}
        fakes[name] = fake.cpu()
        grads[name, "G"] = {n: p.grad.cpu() for n, p in st.g.named_parameters()}
    after_g = [{k: v.cpu().clone() for k, v in net.state_dict().items()}
               for net in (states["card"].g, states["card"].d)]
    for name, st in states.items():
        st.g.load_state_dict(after_g[0])
        st.d.load_state_dict(after_g[1])
        ld = TP.discriminator_step(st, runs[name][1])
        losses[name].update({k: v.item() for k, v in ld.items()})
        grads[name, "D"] = {n: p.grad.cpu() for n, p in st.d.named_parameters()}
    loss_err = max(abs(v - losses["cpu"][k]) / max(abs(losses["cpu"][k]), 1e-6)
                   for k, v in losses["card"].items())
    if loss_err > 1e-4:
        raise AssertionError(f"card vs CPU losses differ by {loss_err} relative: {losses}")
    moved = {name: ((fakes[name] - fakes["cpu"]).abs().max() / fakes["cpu"].abs().max()).item()
             for name in ("card", "cpu jittered")}
    summary = []
    for net in ("G", "D"):
        spread = grad_ratios(grads["cpu jittered", net], grads["cpu", net])
        card = grad_ratios(grads["card", net], grads["cpu", net])
        bar = max(GRAD_REL, GRAD_SPREAD * spread[-1][0])
        bad = [r for r in card if r[0] > bar]
        if bad:
            raise AssertionError(f"{len(bad)} of {len(card)} {net} gradient leaves above {bar:.3e} "
                                 f"of their scale (CPU's own spread {spread[-1]}); worst {bad[-5:]}")
        summary.append(f"{net}: worst leaf {card[-1][0]:.3e} ({card[-1][1]}), "
                       f"{sum(r[0] > GRAD_REL for r in card)} of {len(card)} above {GRAD_REL}, "
                       f"CPU's own spread {spread[-1][0]:.3e}, bar {bar:.3e}")
    log(f"[tcpu] ngf/ndf 16, 64x128, batch 2: G step and D step, card vs CPU plain path: "
        f"losses within {loss_err:.3e} relative (bar 1e-4); generated map moved "
        f"{moved['card']:.3e} by the card's rounding, {moved['cpu jittered']:.3e} by a "
        f"{JITTER:g} relative jitter of crop and target; gradient leaves against their scale, "
        f"bar the larger of {GRAD_REL} and {GRAD_SPREAD:g}x the CPU's own spread under that "
        f"jitter: " + "; ".join(summary) + f"; took {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the per-shape tables here as JSON")
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
    from emlight_tpu_torch.nn.sphere_conv_kernel import KERNELS, sphere_conv_s1
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

    tables = {"serving_shapes": rows}

    def save():
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": smi, **tables}, f, indent=1)

    train = run_training(torch, np, dev, args.seed, tables, save)
    save()
    run_card_vs_cpu(torch, np, dev, args.seed)

    # 10. kernels line
    kernels_line = {"kernels": [{
        "name": "sphere_conv_s1",
        "id": "B1",
        "route": "cuda",
        "source": KERNELS["sphere_conv_s1"][1],
        "replaces": KERNELS["sphere_conv_s1"][2],
        "launches": main_launches,
        "train_launches": train["b1_train_launches"],
        "max_abs_err": worst["float32"],
        "max_err_f32": worst["float32"],
        "max_err_bf16": worst["bfloat16"],
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": total_bound_by,
        "library_ms": None,
    }] + train["entries"]}
    log(smi)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
