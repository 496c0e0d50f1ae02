#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (emlight_tpu_torch) on one GPU.

Drives the port's three main paths at full width (RegressionConfig() and
ProjectorConfig() defaults, weights drawn from seeded torch.Generators):
serving — crop -> DenseNet-BC regressor -> Gaussian-splat guide -> SPADE
generator -> 128x256 HDR env map —, SPADE GAN training — alternating
generator and discriminator steps at batch 8, then with the VGG19 term,
fused, scanned and under use_vae — and regression training —
Adam steps of the DenseNet-BC regressor under the Sinkhorn + L2 loss at
batch 16 —, then serves from files through the inference CLIs (cli.infer,
cli.test_regression: EXR crops and JAX-layout checkpoints in, maps,
previews and pickles out), trains and evaluates from files through the
training CLIs (cli.train_regression, cli.train_projector with --resume,
cli.test_projector, cli.eval_projector, cli.eval_metrics), extracts anchor
GT from panorama files (cli.extract_distribution), runs training and
serving data-parallel (--parallel: one rank at world size 1 on NCCL, two
ranks on the card over gloo), drives the rest of the single-card surface
(the SphereCNN demo, reference-.pth parity, needlet GT, the
spherical-Gaussian fit and the small tools), and holds every hand-written
kernel against its plain PyTorch version. The regressor runs
as the JAX package runs it by default: the concat-free buffer forwards
(nn/densenet_fast.py) in serving and training. Phases, each of which raises
on failure:

1. device   card name and nvidia-smi's name and power limit
2. build    nvcc builds every csrc/*.cu (all started together)
3. check    the sphere-conv kernel vs its plain version on the card at every
            distinct main-path shape, f32 (TF32 off) and bf16, at batch 2
            (and again at the main path's batch in phase 5)
4. slice    4 requests of batch 8 through pipeline_inference, with the
            kernels' launch counts read around them (B1 44 per request; B7 48,
            the regressor's buffer eval forward); env maps
            checked; one batch-1 request compared with the same modules on
            the CPU (plain path)
5. timing   CUDA events, median of 10 after warm-up: per-shape kernel (f32
            and bf16) vs plain version, its bounds on the CUDA cores and on
            the tensor cores (tc) and cuDNN's dense 3x3 conv of the same size
            (a yardstick, not the same function); the regressor's three eval
            forwards at batch 8 (standard, buffer, baked: heads checked
            against the standard's, baked equal to buffer bit for bit),
            generator and pipeline at batch 8; one profiled request: device
            busy time and the top device work
6. train    3 alternating generator + discriminator steps of batch 8
            (create_state, ProjectorConfig(), VGG off), every kernel's launch
            count read around each step; losses finite, parameters, D's u and
            G's BatchNorm statistics changed
7. tcheck   every training kernel (B2 forward, B3/B6/B5 dx, B4 dK) vs its
            plain version at every distinct training shape, f32 and bf16, at
            batch 2 and at the main path's batch (the timed inputs); B3, B2
            and B5 also at --crop_size 512's 256x512 map (B3: 64 -> 3, 128 ->
            64; B2 and B5: the front conv 6 -> 64; batch 2)
8. ttiming  per-shape kernel vs plain version vs bounds and the cuDNN
            yardstick of the same size (B1: the dense conv; B2: the dense
            conv at stride 2; B4: conv2d_weight; B3, B6 and B5:
            conv2d_input, B5's at stride 2),
            B3 against B6 at every stride-1 dx shape, and B6's and B5's
            U GEMM and gather apart (profiler); sums by kernel and by map;
            the G step and the D step at batch 8, with the caching
            allocator's cudaMalloc / cudaFree calls, retries and syncs over
            them; one profiled G step: idle share, top device work
9. tcpu     one G step and one D step at batch 2 on a reduced config, card
            against the CPU plain path: losses, and every gradient leaf
            within a bar measured from the CPU's own spread under a jitter
9b. gan     the rest of GAN training on phase 6's state and batches: a G
            step with the VGG19 perceptual term (random_vgg19_params(0)),
            the term alone, fused_gan_step with VGG (launches asserted: the
            G + D pair's less the D step's generator forward, B1 52), one
            profiled fused step (idle share, top device work),
            scanned_fused_steps over 4 steps under torch.cuda's sync debug
            mode (no host synchronisation inside) against 4 iterated fused
            steps from the same start (bit for bit, with cuDNN's
            deterministic algorithms), a use_vae G and D step (KLD finite, fc_mu
            and fc_var moved); times (CUDA events, median of 5) and peak
            memory; then phase 9's card-vs-CPU comparison for a fused step
            with VGG and a use_vae G step
10. rtrain  3 regression train_steps of batch 16 (RegressionConfig(), the
            default train_forward "buffer"), the dense-conv kernels'
            launches read around each (48 each); metrics
            finite, parameters and running variances changed; then 10 steps
            on one batch, the loss falls
11. rcheck  B7, B7' (dx, da, db) and B8 vs their plain versions at the
            path's shapes at batch 2 and 16 and two ragged ones, f32 and bf16
12. rtiming per shape: kernel, plain version, cuDNN call, bounds; the step at
            batch 16, with the allocator's calls over it (as in phase 8); one
            profiled step: idle share, top device work; then the step's four
            routes (train_forward buffer / standard, f32 / bf16): 48 launches
            each of B7, B7', B8 per step asserted, time, peak memory, one
            profiled step each; the buffer step's gradients against the
            standard step's (f32, measured bar), every route's losses
13. rcpu    one train_step at batch 4 on a reduced config, card against the
            CPU plain path: losses and every gradient leaf (measured bar)
14. cli     the inference CLIs from files at full width: 17 synthetic crop
            .exr files (PIZ HALF, ZIP FLOAT, ZIP HALF; two at 384x512) and the
            seeded models written as JAX-layout checkpoints; cli.infer at
            batch 8 (B1's launches read around it, 44 per batch) and
            cli.test_regression --render; maps equal pipeline_inference bit
            for bit, one against the CPU plain path, the two CLIs' pickles
            agree, every PNG decodes to its array; then infer timed on 8
            full batches of PIZ HALF crops (B1's launches read, 44 x 8):
            crops/s, host ms per crop (read, tonemap + resize, write),
            pipeline_inference's CUDA-event span per batch
15. tcli    training and evaluation from files at full width: a synthetic
            Laval-layout dataset (32 PIZ HALF crops at 192x256 and warped
            panoramas at 128x256; GT pickles of 96 and 128 anchors);
            cli.train_regression (batch 16) and cli.train_projector (batch
            8) for 1 epoch each, then --resume to 2 epochs from their
            opt.json, and one train_regression --dtype bfloat16 epoch;
            train_projector --scan_steps 4 --vgg_random for an epoch, then
            --resume --fused to 2 (metrics.csv rows with VGG);
            every kernel's launches read around each run (48
            each per regression step; G + D per GAN step); resumed runs
            start at the saved step, restored states equal their files bit
            for bit, metrics.csv finite; cli.test_projector (maps equal
            inference bit for bit; B1 44 per batch), cli.eval_projector and
            cli.eval_metrics (finite JSON lines); each loop's median step
            (CUDA events) beside phases 8 and 12, its wait on the data
            queue, read_hdr native beside core/exr.py
16. extract anchor GT from 64 synthetic PIZ HALF panoramas at 128x256
            through cli.extract_distribution (batch 16, 128 anchors):
            panoramas/s, host load_batch ms per batch, the card's extraction
            ms per batch; pickles against extract_anchors on the CPU; the
            anchor sums as index_add_ beside the one-hot matmul
16b. dist   data-parallel training and serving (dist/, --parallel): (a)
            train_regression, train_projector --fused --vgg_random, infer
            and test_projector with --parallel at world size 1 on NCCL,
            each byte for byte with its serial run (cuDNN deterministic);
            (b) two ranks spawned on this card over gloo with CUDA tensors:
            the regression step at global batch 16 (buffer and standard
            forwards) and the G, D and fused steps with VGG at global
            batch 8, every rank's launches asserted per step, the averaged
            gradients equal on both ranks and within phase 9's bar of one
            device on the global batch; step times, which are no scaling
            figures (gloo through the host, one shared card); (c) the same
            over NCCL across cards where there are two or more, else
            logged as skipped
16c. surface the rest of the single-card surface (run_surface): (a) the
            SphereCNN demo at 60x60, batch 32: B1, B4 and B6 against their
            plain versions at the demo's shapes (f32 with TF32 off, bf16)
            and timed beside their bounds, SphereNet steps with every
            kernel's launches asserted per step (B1 2, B4 2, B6 1), one
            profiled, cli.sphere_demo --train 200 (accuracy above 0.3);
            (b) cli.verify_parity on full-size random reference .pth files
            (DenseNet-BC (16,16,16), generator ngf 64, discriminator ndf
            64), each within 1e-3, B1 44 around the generator, B1 4 and B2
            6 around the discriminator; (c) cli.needlets_gt --jmax 2 and 3
            on 16 of phase 16's panoramas, card against CPU; (d)
            fit_spherical_gaussians (3 lights, 500 steps) under torch.cuda's
            sync debug mode "error"; (e) image_sinkhorn card vs CPU,
            cli.preview and cli.modify_pickles on phase 16's files
17. kernels one JSON line with every ported kernel, each with its bound on
            the CUDA cores (bound_ms) and on the tensor cores (tc_bound_ms)
            and its launches in phase 15 (tcli_launches; B7's in serving,
            serving_launches; B1-B6's in phase 9b, gan_launches, and per
            fused step, fused_step_launches; phase 16c's sphere_demo
            --train 200 and verify_parity runs, demo_launches and
            parity_launches)

The last line of stdout is {"ok": true, "device": {...}}. Without CUDA, or
run from a directory without the package beside it, it exits non-zero and
prints no result. --out writes the per-shape tables as JSON.

    python3 chip_smoke.py [--seed 0] [--out FILE]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, 700 W): f32 on the CUDA cores,
# and on the tensor cores (tc): f32 as 3xTF32 (495 / 3 TFLOP/s), bf16 989
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
LAUNCHES_PER_FORWARD = 44
REQUESTS, BATCH = 4, 8  # the main path: 4 requests of batch 8
TRAIN_STEPS = 3         # the training path: 3 alternating G + D steps of batch BATCH
# kernel launches per step at num_d 2, n_layers_d 4 (D runs on 2B): the G
# step skips dx of the 7 mlp_shared convs (constant guide) and dK of the
# frozen D; the D step runs G without grad and needs no dx into D's input.
# Stride-1 dx takes B6 (sphere_conv_dx_s1_triple) below UMAJOR_MIN_PIXELS,
# 32768 (the 4x8 to 64x128 maps), and B3 (sphere_conv_dx_s1) at 128x256: 34
# + 7 of the G step's 41, and all 4 of the D step's (D's stride-1 convs read
# 16x32 and 8x16)
EXPECTED_G_STEP = {"sphere_conv_s1": 48, "sphere_conv_s2": 6, "sphere_conv_dx_s1": 7,
                   "sphere_conv_dx_s1_triple": 34, "sphere_conv_dk": 44,
                   "sphere_conv_dx_s2": 6}
EXPECTED_D_STEP = {"sphere_conv_s1": 48, "sphere_conv_s2": 6, "sphere_conv_dx_s1": 0,
                   "sphere_conv_dx_s1_triple": 4, "sphere_conv_dk": 10,
                   "sphere_conv_dx_s2": 4}
# the fused step (phase 9b): the G step's launches and the D step's but for
# the D step's generator forward (B1 44), which the fused step saves: B1 52
EXPECTED_FUSED_STEP = {n: EXPECTED_G_STEP[n] + EXPECTED_D_STEP[n]
                       - (LAUNCHES_PER_FORWARD if n == "sphere_conv_s1" else 0)
                       for n in EXPECTED_G_STEP}
SCAN_STEPS = 4  # phase 9b's scanned_fused_steps
# the regression training path: full width, the reference's batch 16
# (RegressionNetwork/train.py:25); each of the 48 dense layers launches the
# fused conv forward (B7), its dx (B7') and its dK (B8) once per step
REG_BATCH, REG_STEPS, REG_FALL_STEPS = 16, 3, 10
EXPECTED_REG_STEP = {"dense_conv_fwd": 48, "dense_conv_dx": 48, "dense_conv_dk": 48}
REG_METRICS = {"loss", "dist_emloss", "dist_l2loss", "intensity_loss", "rgb_loss",
               "ambient_loss"}
# --crop_size 512's outer stride-1 convs, whose dx B3 is held to at batch 2,
# and its discriminator's front conv, which B2 (forward) and B5 (dx) are
# held to
WIDE_DX_SHAPES = [(2, 256, 512, 64, 3, 1), (2, 256, 512, 128, 64, 1)]
WIDE_S2_SHAPES = [(2, 256, 512, 6, 64, 2)]
# card vs CPU gradients (phases 9 and 13): each leaf within the larger of GRAD_REL and
# GRAD_SPREAD times the CPU's own spread, the change a JITTER-relative
# perturbation of the batch makes to the CPU's gradients (see grad_ratios)
GRAD_REL, GRAD_FLOOR, GRAD_SPREAD, JITTER = 1e-3, 1e-3, 4.0, 1e-6
# the cuDNN call timed beside each kind of kernel as its yardstick
YARDSTICK = {"fwd": "conv", "dk": "conv2d_weight", "dx": "conv2d_input"}


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


# the caching allocator's calls that stall the host or the device: a
# cudaMalloc or cudaFree, a retry after a failed allocation, a sync of all
# streams (torch.cuda.memory_stats keys)
ALLOC_EVENTS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
                "num_sync_all_streams")


def allocator_events(torch, fn):
    """fn()'s result and how often each of ALLOC_EVENTS happened while it ran."""
    before = torch.cuda.memory_stats()
    out = fn()
    after = torch.cuda.memory_stats()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in ALLOC_EVENTS}


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


def _bound(flops, nbytes, dtype, tc):
    """(ms, "operations" or "bytes"): the larger of flops over the card's
    peak for the type (on the tensor cores if tc) and bytes over the memory
    rate."""
    t_ops = flops / (PEAK_TC_FLOPS if tc else PEAK_FLOPS)[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv_bound_ms(b, h, w, cin, cout, dtype, tc=False):
    """Least time for one sphere conv: the larger of its operations over the
    card's peak for the type and its bytes (each input read once, the output
    written once) over the memory rate."""
    size = 4 if dtype == "float32" else 2
    flops = 2 * b * h * w * 9 * cin * cout + 8 * b * h * w * 9 * cin
    nbytes = (b * h * w * cin * size + 9 * cin * cout * size + cout * 4
              + h * 36 * 16 + b * h * w * cout * 4)
    return _bound(flops, nbytes, dtype, tc)


def kernel_bound_ms(kind, b, h, w, cin, cout, stride, dtype, fanin=64, tc=False):
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
    return _bound(flops, nbytes, dtype, tc)


def dense_bound_ms(kind, b, h, w, cin, cout, dtype="float32", tc=False):
    """Least time for one launch of a dense-layer conv kernel at x (b, h, w,
    cin) -> cout: the larger of its operations (2*B*H*W*9*Cin*Cout for the
    conv, plus the affine or the post-scale and dA products on B*H*W*Cin)
    over the card's peak for the type and its bytes (inputs once, outputs
    once, f32 outputs) over the memory rate. Returns (ms, "operations" or
    "bytes")."""
    size = 4 if dtype == "float32" else 2
    px = b * h * w
    flops = 2 * px * 9 * cin * cout + {"fwd": 2, "dx": 3, "dk": 2}[kind] * px * cin
    x_b, g_b, k_b, vec = px * cin * size, px * cout * size, 9 * cin * cout * size, cin * 4
    nbytes = {"fwd": x_b + k_b + 2 * vec + px * cout * 4,
              "dx": g_b + x_b + k_b + vec + px * cin * 4 + 2 * vec,
              "dk": x_b + g_b + 2 * vec + 9 * cin * cout * 4}[kind]
    return _bound(flops, nbytes, dtype, tc)


def dense_conv_yardstick(torch, x, cout, stride=1):
    """cuDNN's dense 3x3 conv (padding 1, channels_last, TF32 off as main
    sets it) at the sphere conv's (B, H, W, Cin, Cout) and stride: a
    yardstick of what a library conv of that size costs, not the same
    function."""
    import torch.nn.functional as F

    x_cl = x.permute(0, 3, 1, 2)  # NHWC in memory: channels_last
    w_cl = torch.randn(cout, x.shape[3], 3, 3, device=x.device).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(x_cl, w_cl, stride=stride, padding=1)


def dense_grad_yardstick(torch, kind, x, g, stride):
    """cuDNN's gradient of a dense 3x3 conv (padding 1, channels_last, TF32
    off as main sets it) at the sphere conv's sizes and stride:
    ``conv2d_weight`` for dK (beside B4), ``conv2d_input`` for dx (beside B3
    and B6; at stride 2 beside B5). Yardsticks of what a library gradient of
    that size costs, not the same function."""
    x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # NHWC in memory
    cin, cout = x.shape[3], g.shape[3]
    w_cl = torch.randn(cout, cin, 3, 3, device=x.device).contiguous(
        memory_format=torch.channels_last)
    if kind == "dk":
        return lambda: torch.nn.grad.conv2d_weight(x_cl, (cout, cin, 3, 3), g_cl, stride=stride,
                                                   padding=1)
    return lambda: torch.nn.grad.conv2d_input(tuple(x_cl.shape), w_cl, g_cl, stride=stride,
                                              padding=1)


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
    def kernel_of(kind, shape):
        stride = shape[-1]
        if kind == "dx" and stride == 1 and shape[1] * shape[2] < SK.UMAJOR_MIN_PIXELS:
            return "sphere_conv_dx_s1_triple"
        return {"fwd": f"sphere_conv_s{stride}", "dx": f"sphere_conv_dx_s{stride}",
                "dk": "sphere_conv_dk"}[kind]

    per_step: dict = {}
    for step_name, seen in calls.items():
        for kind, shape in seen:
            key = (kernel_of(kind, shape), kind, shape)
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
    # B3 on the 256x512 map of --crop_size 512 (wider than two buffers of its
    # g rows in shared memory: it reads them from device memory)
    for shape in WIDE_DX_SHAPES:
        check("sphere_conv_dx_s1", "dx", shape, kernel_inputs("dx", *shape))
    log(f"[tcheck] sphere_conv_dx_s1 at {WIDE_DX_SHAPES} (B, H, W, Cin, Cout, stride) matches "
        f"dx_plain in f32 and bf16")
    for shape in WIDE_S2_SHAPES:
        check("sphere_conv_s2", "fwd", shape, kernel_inputs("fwd", *shape))
        check("sphere_conv_dx_s2", "dx", shape, kernel_inputs("dx", *shape))
    log(f"[tcheck] at {WIDE_S2_SHAPES} sphere_conv_s2 matches sphere_conv_plain and "
        f"sphere_conv_dx_s2 matches dx_plain, in f32 and bf16")

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
               "bound_ms": bound, "bound_by": bound_by,
               "tc_bound_ms": kernel_bound_ms(kind, b, h, w, cin, cout, stride, "float32",
                                              fanin, tc=True)[0]}
        if kind == "fwd":
            row["dense_conv_yardstick_ms"] = cuda_ms(
                torch, dense_conv_yardstick(torch, inputs[0], cout, stride), warmup=1, iters=5)
        else:
            row["dense_conv_yardstick_ms"] = cuda_ms(
                torch, dense_grad_yardstick(torch, kind, inputs[0], inputs[3], stride),
                warmup=1, iters=5)
        if kind == "dx" and stride == 1:
            # B3 and B6 on the same inputs: where the routing gate should lie
            x_, k_, _, g_ = inputs
            ref = dx_plain(g_, k_, tuple(x_.shape), 1)
            for alt in ("sphere_conv_dx_s1", "sphere_conv_dx_s1_triple"):
                if alt == name:
                    row[f"{alt}_ms"] = row["ms"]
                else:
                    fn = wrappers[alt]
                    torch.testing.assert_close(fn(g_, k_, tuple(x_.shape)), ref, rtol=1e-4,
                                               atol=1e-4, msg=lambda m: f"{alt} {shape}: {m}")
                    row[f"{alt}_ms"] = cuda_ms(torch, lambda: fn(g_, k_, tuple(x_.shape)),
                                               warmup=1, iters=5)
            del ref
        if name in ("sphere_conv_dx_s1_triple", "sphere_conv_dx_s2"):
            # the U GEMM's and the gather's device time per launch, the mean
            # over 5 profiled launches (a profile of one launch missed its
            # first kernel)
            prof = device_profile(torch, lambda: [kern() for _ in range(5)], top=2)
            if prof is not None:
                row["parts_ms"] = {n.split("::", 1)[-1].split("(")[0]: ms / k
                                   for n, ms, k in prof[2]}
        rows.append(row)
        log(f"[ttiming] {name} {kind} B{b} {h}x{w} {cin}->{cout} s{stride} "
            f"x{row['per_g_step']}/G x{row['per_d_step']}/D: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}), tc bound "
            f"{row['tc_bound_ms']:.4f} ms"
            + (f", cuDNN dense {YARDSTICK[kind]} yardstick "
               f"{row['dense_conv_yardstick_ms']:.4f} ms" if "dense_conv_yardstick_ms" in row
               else "")
            + "".join(f", {k[:-3]} {v:.4f} ms" for k, v in row.items()
                      if k.startswith("sphere_conv_dx_s1"))
            + "".join(f", {k} {v:.4f} ms" for k, v in row.get("parts_ms", {}).items()))
        del inputs, kern, plain
    tables["train_shapes"] = rows
    log("[tcheck] at batches 2 and the main path's: " + "; ".join(
        f"{n} f32 max|err| {worst[n]['float32']:.3e}, bf16 {worst[n]['bf16_rel']:.3e} of max|ref|"
        for n in names))

    step_ms, step_alloc = {}, {}
    for what, fn in (("G", lambda: TP.generator_step(state, batches[0])),
                     ("D", lambda: TP.discriminator_step(state, batches[0]))):
        step_ms[what], step_alloc[what] = allocator_events(
            torch, lambda: cuda_ms(torch, fn, warmup=1, iters=5))
    per_kernel = {}
    for n in names:
        sel = [r for r in rows if r["kernel"] == n]
        yard = all("dense_conv_yardstick_ms" in r for r in sel)
        per = {key: sum(r[key] * (r["per_g_step"] + r["per_d_step"]) for r in sel)
               for key in ("ms", "plain_ms", "bound_ms", "tc_bound_ms")
               + (("dense_conv_yardstick_ms",) if yard else ())}
        ops = sum(r["bound_ms"] * (r["per_g_step"] + r["per_d_step"]) for r in sel
                  if r["bound_by"] == "operations")
        per["bound_by"] = "operations" if ops >= per["bound_ms"] / 2 else "bytes"
        per_kernel[n] = per
    log(f"[ttiming] batch {BATCH}: generator_step {step_ms['G']:.3f} ms, discriminator_step "
        f"{step_ms['D']:.3f} ms; allocator events over the 6 timed steps of each: {step_alloc}; "
        f"per G+D step: " + "; ".join(
            f"{n} kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.3f}, "
            f"tc bound {v['tc_bound_ms']:.3f}"
            + (f", cuDNN yardstick {v['dense_conv_yardstick_ms']:.3f}"
               if "dense_conv_yardstick_ms" in v else "")
            for n, v in per_kernel.items()))
    by_map: dict = {}
    for r in rows:
        n = r["per_g_step"] + r["per_d_step"]
        agg = by_map.setdefault((r["kernel"], r["shape"][1], r["shape"][2]),
                                {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                 "tc_bound_ms": 0.0, "dense_conv_yardstick_ms": 0.0})
        agg["launches"] += n
        for key in ("ms", "plain_ms", "bound_ms", "tc_bound_ms", "dense_conv_yardstick_ms"):
            agg[key] += r.get(key, 0.0) * n
    for (n, h, w), v in sorted(by_map.items()):
        log(f"[ttiming] by map, per G+D step: {n} {h}x{w} x{v['launches']}: kernel "
            f"{v['ms']:.3f} ms, plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.4f}, tc bound "
            f"{v['tc_bound_ms']:.4f}"
            + (f", cuDNN yardstick {v['dense_conv_yardstick_ms']:.3f}"
               if v["dense_conv_yardstick_ms"] else ""))
    cross: dict = {}
    for r in rows:
        if "sphere_conv_dx_s1_ms" in r:
            n = r["per_g_step"] + r["per_d_step"]
            agg = cross.setdefault((r["shape"][1], r["shape"][2]),
                                   {"launches": 0, "B3": 0.0, "B6": 0.0, "routed": r["kernel"]})
            agg["launches"] += n
            agg["B3"] += r["sphere_conv_dx_s1_ms"] * n
            agg["B6"] += r["sphere_conv_dx_s1_triple_ms"] * n
    for (h, w), v in sorted(cross.items()):
        log(f"[ttiming] stride-1 dx by map, per G+D step: {h}x{w} x{v['launches']}: B3 "
            f"{v['B3']:.3f} ms, B6 {v['B6']:.3f} ms; routed to {v['routed']}")
    tables["train_dx_s1_by_map"] = {f"{h}x{w}": v for (h, w), v in sorted(cross.items())}
    tables["train_steps_ms"] = step_ms
    tables["train_steps_allocator"] = step_alloc
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
            "tc_bound_ms": v["tc_bound_ms"], "bound_by": v["bound_by"], "library_ms": None,
        })
        if "dense_conv_yardstick_ms" in v:
            entries[-1]["dense_conv_yardstick_ms"] = v["dense_conv_yardstick_ms"]
    return {"entries": entries, "b1_train_launches": totals["sphere_conv_s1"],
            "b1_train": per_kernel["sphere_conv_s1"], "state": state, "batches": batches}



def small_projector_cfg():
    """Phases 9 and 9b's reduced config: ngf 16, ndf 16, 64x128 env maps."""
    from emlight_tpu_torch.config import AnchorConfig, ProjectorConfig

    return dataclasses.replace(ProjectorConfig(), ngf=16, ndf=16, crop_size=128,
                               anchors=dataclasses.replace(AnchorConfig(), env_h=64, env_w=128))


def card_vs_cpu_runs(np, dev, cfg, seed: int) -> dict:
    """Phases 9 and 9b's three runs of a step, as {name: (device, batch)}:
    on the card, on the CPU, and on the CPU with crop and target jittered
    by JITTER relative (the CPU's own spread)."""
    from emlight_tpu_torch.train.data import synthetic_projector_batch

    sb = synthetic_projector_batch(2, n_anchors=cfg.anchors.n_anchors, crop_size=64,
                                   env_hw=(64, 128), seed=seed + 30)
    rng = np.random.default_rng(seed + 31)
    jittered = {k: (v * (1 + JITTER * rng.standard_normal(v.shape))).astype(np.float32)
                if k in ("crop", "warped") else v for k, v in sb.items()}
    return {"card": (dev, sb), "cpu": ("cpu", sb), "cpu jittered": ("cpu", jittered)}


def hold_card_to_cpu(losses: dict, grads: dict, nets) -> tuple[float, list]:
    """The card's losses within 1e-4 relative of the CPU's, and each
    gradient leaf of each net within the larger of GRAD_REL and GRAD_SPREAD
    times the CPU's own spread (grad_ratios of the jittered run); raises
    otherwise. Returns the losses' worst relative error and one summary per
    net."""
    loss_err = max(abs(v - losses["cpu"][k]) / max(abs(losses["cpu"][k]), 1e-6)
                   for k, v in losses["card"].items())
    if loss_err > 1e-4:
        raise AssertionError(f"card vs CPU losses differ by {loss_err} relative: {losses}")
    summary = []
    for net in nets:
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
    return loss_err, summary


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
    from emlight_tpu_torch.train import projector as TP

    small = small_projector_cfg()
    t0 = time.perf_counter()
    runs = card_vs_cpu_runs(np, dev, small, seed)
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
    loss_err, summary = hold_card_to_cpu(losses, grads, ("G", "D"))
    moved = {name: ((fakes[name] - fakes["cpu"]).abs().max() / fakes["cpu"].abs().max()).item()
             for name in ("card", "cpu jittered")}
    log(f"[tcpu] ngf/ndf 16, 64x128, batch 2: G step and D step, card vs CPU plain path: "
        f"losses within {loss_err:.3e} relative (bar 1e-4); generated map moved "
        f"{moved['card']:.3e} by the card's rounding, {moved['cpu jittered']:.3e} by a "
        f"{JITTER:g} relative jitter of crop and target; gradient leaves against their scale, "
        f"bar the larger of {GRAD_REL} and {GRAD_SPREAD:g}x the CPU's own spread under that "
        f"jitter: " + "; ".join(summary) + f"; took {time.perf_counter() - t0:.1f} s")


def state_snapshot(state) -> dict:
    """A copy of a ProjectorState's models, optimizers and step counts."""
    return {"g": copy.deepcopy(state.g.state_dict()), "d": copy.deepcopy(state.d.state_dict()),
            "opt_g": copy.deepcopy(state.opt_g.state_dict()),
            "opt_d": copy.deepcopy(state.opt_d.state_dict()),
            "steps": (state.step, state.d_step)}


def state_restore(state, snap: dict) -> None:
    """Put a state_snapshot back; the snapshot stays as it was (an
    optimizer's load_state_dict adopts the moment tensors it is given,
    which its next step would update in place)."""
    state.g.load_state_dict(snap["g"])
    state.d.load_state_dict(snap["d"])
    state.opt_g.load_state_dict(copy.deepcopy(snap["opt_g"]))
    state.opt_d.load_state_dict(copy.deepcopy(snap["opt_d"]))
    state.step, state.d_step = snap["steps"]


def run_gan_objective(torch, np, dev, seed: int, tables: dict, train: dict, smi) -> dict:
    """Phase 9b: the rest of GAN training at full width, batch BATCH, on
    phase 6's state and batches: (a) a G step with the VGG19 term on
    (random_vgg19_params(0), perf-identical to pretrained weights); (b)
    fused_gan_step with VGG; (c) scanned_fused_steps over SCAN_STEPS
    against as many iterated fused steps from the same start, the scan run
    under torch.cuda's sync debug mode (a host synchronisation inside it
    fails the phase), bit for bit under cuDNN's deterministic algorithms
    (its default weight gradient of the encoder's convs differs run to
    run); (d) a use_vae G step and D step; (e) card against the
    CPU plain path, as phase 9: a fused step with VGG and a use_vae G step.
    Every step's kernel launches are read around it and asserted (VGG adds
    none; the fused step EXPECTED_FUSED_STEP). Times by CUDA events (median
    of 5), peak memory, one profiled fused step. Returns the launches of
    every kernel over the phase and the numbers it logs."""
    import warnings

    from emlight_tpu_torch.nn import sphere_conv_kernel as SK
    from emlight_tpu_torch.nn.vgg import VGG19Features, random_vgg19_params, vgg_perceptual_loss
    from emlight_tpu_torch.train import projector as TP
    from emlight_tpu_torch.train.checkpoint import train_state_tree

    t_phase = time.perf_counter()
    state, batches = train["state"], train["batches"]
    cfg = state.cfg
    names = list(EXPECTED_G_STEP)
    wrappers = {n: getattr(SK, n) for n in names}
    launches = dict.fromkeys(names, 0)
    vgg = VGG19Features(random_vgg19_params(0), device=dev)

    def counted(fn, per_step: dict, steps: int, what: str):
        torch.cuda.synchronize()
        for w_ in wrappers.values():
            w_.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {n: wrappers[n].launches for n in names}
        want = {n: per_step[n] * steps for n in names}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for n in names:
            launches[n] += got[n]
        return out

    def finite(metrics: dict, what: str):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f"{what}: non-finite {bad}")

    def peak_gib(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2 ** 30

    out: dict = {}
    # (a) the G step with the VGG19 term
    g_losses, _ = counted(lambda: TP.generator_step(state, batches[0], vgg), EXPECTED_G_STEP, 1,
                          "G step with VGG")
    finite(g_losses, "G step with VGG")
    if not g_losses["VGG"].item() > 0:
        raise AssertionError(f"VGG term {g_losses['VGG'].item()}")
    out["g_vgg_ms"] = cuda_ms(torch, lambda: TP.generator_step(state, batches[0], vgg),
                              warmup=1, iters=5)
    out["g_vgg_peak_gib"] = peak_gib(lambda: TP.generator_step(state, batches[0], vgg))
    out["g_peak_gib"] = peak_gib(lambda: TP.generator_step(state, batches[0]))
    some_map = torch.rand(BATCH, *batches[0]["warped"].shape[1:], device=dev) * 50

    def vgg_term():  # the term alone: fake and real forwards, the fake's backward
        f = some_map.clone().requires_grad_(True)
        vgg_perceptual_loss(vgg, f, batches[0]["warped"]).backward()

    out["vgg_term_ms"] = cuda_ms(torch, vgg_term, warmup=1, iters=5)
    log(f"[gan] {smi}: batch {BATCH}: generator_step with VGG {out['g_vgg_ms']:.3f} ms "
        f"(phase 8's without: {tables['train_steps_ms']['G']:.3f} ms), the VGG term alone "
        f"(fake and real forwards, fake's backward) {out['vgg_term_ms']:.3f} ms; peak memory "
        f"{out['g_vgg_peak_gib']:.3f} GiB with VGG, {out['g_peak_gib']:.3f} without; losses "
        + ", ".join(f"{k} {v.item():.5g}" for k, v in g_losses.items())
        + f"; launches as phase 8's G step: {EXPECTED_G_STEP}")

    # (b) the fused step with VGG
    u_before = [b_.clone() for n, b_ in state.d.named_buffers() if n.endswith(".u")]
    metrics, _ = counted(lambda: TP.fused_gan_step(state, batches[1], vgg), EXPECTED_FUSED_STEP,
                         1, "fused step")
    finite(metrics, "fused step")
    if any(torch.equal(a, b_) for a, b_ in zip(
            u_before, [b_ for n, b_ in state.d.named_buffers() if n.endswith(".u")])):
        raise AssertionError("fused step: a D spectral u did not change")
    out["fused_ms"] = cuda_ms(torch, lambda: TP.fused_gan_step(state, batches[1], vgg),
                              warmup=1, iters=5)
    out["fused_peak_gib"] = peak_gib(lambda: TP.fused_gan_step(state, batches[1], vgg))
    pair_ms = out["g_vgg_ms"] + tables["train_steps_ms"]["D"]
    log(f"[gan] fused_gan_step with VGG {out['fused_ms']:.3f} ms against the alternating G "
        f"(with VGG) + D {pair_ms:.3f} ms ({out['fused_ms'] / pair_ms:.4f}x) and phase 8's "
        f"VGG-off G + D {sum(tables['train_steps_ms'].values()):.3f} ms; peak memory "
        f"{out['fused_peak_gib']:.3f} GiB; launches {EXPECTED_FUSED_STEP} (the pair's less the "
        f"D step's generator forward, {LAUNCHES_PER_FORWARD} of B1); losses "
        + ", ".join(f"{k} {v.item():.5g}" for k, v in metrics.items()))
    prof = device_profile(torch, lambda: TP.fused_gan_step(state, batches[1], vgg), top=10)
    if prof is None:
        log("[gan] the profiler saw no device work: idle share not measured")
    else:
        wall_ms, busy_ms, ranked = prof
        out["fused_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                                "top": [list(r) for r in ranked]}
        log(f"[gan] one fused step under the profiler: {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top device work:")
        for name, ms, n in ranked:
            log(f"[gan]   {ms:9.3f} ms  {ms / busy_ms:.4f}  x{n:<4d} {name[:100]}")

    # (c) the scan against the iterated fused step, from one start, bit for
    # bit: with cuDNN's deterministic algorithms (the hand-written kernels
    # sum in a fixed order; cuDNN's default weight gradient of the encoder's
    # convs does not, and differs run to run)
    stacked = {k: torch.stack([batches[i % len(batches)][k] for i in range(SCAN_STEPS)])
               for k in batches[0]}
    start = state_snapshot(state)

    def iterated():
        rows = [TP.fused_gan_step(state, {k: v[i] for k, v in stacked.items()}, vgg)[0]
                for i in range(SCAN_STEPS)]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def scan_watched():  # under torch.cuda's sync debug mode: a sync warns
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return TP.scanned_fused_steps(state, stacked, vgg)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    ends = {}
    torch.backends.cudnn.deterministic = True
    try:
        for what in ("iterated", "scanned"):
            state_restore(state, start)
            if what == "scanned":
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    m, _ = counted(scan_watched, EXPECTED_FUSED_STEP, SCAN_STEPS,
                                   "scanned_fused_steps")
                syncs = [str(w_.message) for w_ in caught  # (not the mode's own notice)
                         if "synchroniz" in str(w_.message)
                         and "prototype" not in str(w_.message)]
                if syncs:
                    raise AssertionError(f"scanned_fused_steps synchronised the host "
                                         f"{len(syncs)} times: {syncs[:3]}")
            else:
                m = counted(iterated, EXPECTED_FUSED_STEP, SCAN_STEPS, what)
            finite(m, what)
            ends[what] = (train_state_tree(state), m)
    finally:
        torch.backends.cudnn.deterministic = False
    (a, ma), (b, mb) = ends["iterated"], ends["scanned"]
    diff = [k for k in ma if not torch.equal(ma[k], mb[k])]

    def compare(x, y, where=""):
        for k, v in x.items():
            if isinstance(v, dict):
                compare(v, y[k], f"{where}{k}/")
            elif not np.array_equal(v, y[k]):
                diff.append(where + k)

    compare(a, b)
    if diff:
        raise AssertionError(f"the scan differs from {SCAN_STEPS} iterated fused steps at "
                             f"{len(diff)} leaves or metrics: {diff[:5]}")
    state_restore(state, start)
    t0 = time.perf_counter()
    out["scan_ms_per_step"] = cuda_ms(
        torch, lambda: TP.scanned_fused_steps(state, stacked, vgg), warmup=1, iters=3) / SCAN_STEPS
    log(f"[gan] scanned_fused_steps over {SCAN_STEPS} steps: no host synchronisation inside "
        f"(sync debug mode); launches {SCAN_STEPS} x the fused step's; its metrics and final "
        f"state equal {SCAN_STEPS} iterated fused_gan_step calls from the same start bit for "
        f"bit (cuDNN's deterministic algorithms for the comparison); "
        f"{out['scan_ms_per_step']:.3f} ms per step (CUDA events, median of 3 scans, cuDNN's "
        f"default algorithms) against fused_gan_step's {out['fused_ms']:.3f}; timing took "
        f"{time.perf_counter() - t0:.1f} s")
    del start, ends, a, b

    # (d) use_vae at full width
    vstate = TP.create_state(dataclasses.replace(cfg, use_vae=True), device=dev, seed=seed + 40)
    heads = {n: p.detach().clone() for n, p in vstate.g.named_parameters()
             if n.startswith(("netE.fc_mu", "netE.fc_var"))}
    vg, _ = counted(lambda: TP.generator_step(vstate, batches[0]), EXPECTED_G_STEP, 1,
                    "use_vae G step")
    vd = counted(lambda: TP.discriminator_step(vstate, batches[0]), EXPECTED_D_STEP, 1,
                 "use_vae D step")
    finite({**vg, **vd}, "use_vae steps")
    moved = [n for n, p in vstate.g.named_parameters() if n in heads and not torch.equal(p, heads[n])]
    if len(moved) != len(heads) or len(heads) != 4:
        raise AssertionError(f"use_vae G step moved {moved} of {sorted(heads)}")
    out["vae_g_ms"] = cuda_ms(torch, lambda: TP.generator_step(vstate, batches[0]), warmup=1,
                              iters=5)
    log(f"[gan] use_vae: G step KLD {vg['KLD'].item():.6g}, loss_G {vg['loss_G'].item():.6g}, "
        f"D step loss_D {vd['loss_D'].item():.6g}; fc_mu and fc_var moved ({len(moved)} "
        f"leaves); launches as phase 8's G and D steps; G step {out['vae_g_ms']:.3f} ms")
    del vstate

    # (e) card against the CPU plain path at phase 9's reduced config
    t0 = time.perf_counter()
    small = small_projector_cfg()
    runs = card_vs_cpu_runs(np, dev, small, seed)
    losses, grads = {}, {}
    for name, (d, batch) in runs.items():
        st = TP.create_state(small, device=d, seed=seed + 20)
        m, _ = TP.fused_gan_step(st, batch, VGG19Features(random_vgg19_params(0), device=d))
        losses[name] = {k: v.item() for k, v in m.items()}
        grads[name, "G"] = {n: p.grad.cpu() for n, p in st.g.named_parameters()}
        grads[name, "D"] = {n: p.grad.cpu() for n, p in st.d.named_parameters()}
    fused_err, fused_summary = hold_card_to_cpu(losses, grads, ("G", "D"))
    vsmall = dataclasses.replace(small, use_vae=True)
    eps = torch.from_numpy(np.random.default_rng(seed + 32).standard_normal(
        (2, 32 * small.ngf)).astype(np.float32))
    losses, grads = {}, {}
    for name, (d, batch) in runs.items():
        st = TP.create_state(vsmall, device=d, seed=seed + 21)
        m, _ = TP.generator_step(st, batch, eps=eps.to(d))
        losses[name] = {k: v.item() for k, v in m.items()}
        grads[name, "G"] = {n: p.grad.cpu() for n, p in st.g.named_parameters()}
    vae_err, vae_summary = hold_card_to_cpu(losses, grads, ("G",))
    log(f"[gan] card vs CPU plain path, phase 9's config and bars: fused step with VGG: losses "
        f"within {fused_err:.3e}; " + "; ".join(fused_summary) + f". use_vae G step (one eps "
        f"on both): losses within {vae_err:.3e}; " + "; ".join(vae_summary)
        + f"; took {time.perf_counter() - t0:.1f} s")
    out["launches"] = launches
    log(f"[gan] launches over the phase: {launches}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def run_regression(torch, np, dev, seed: int, tables: dict, save) -> list:
    """Phases 10-12: the regression training path at full width
    (RegressionConfig(), batch 16), the dense-layer conv kernels against
    their plain versions and the timings. Calls save() once the tables are
    in `tables`. Returns the kernels-line entries of B7, B7' and B8."""
    import torch.nn.functional as F

    from emlight_tpu_torch.config import RegressionConfig
    from emlight_tpu_torch.nn import dense_conv as DC
    from emlight_tpu_torch.nn import dense_conv_kernel as DK
    from emlight_tpu_torch.train import regression as TR
    from emlight_tpu_torch.train.data import synthetic_regression_batch

    names = list(EXPECTED_REG_STEP)
    wrappers = {n: getattr(DK, n) for n in names}
    cfg = RegressionConfig()

    def make_batch(s):
        b = synthetic_regression_batch(REG_BATCH, cfg.anchors.regression_anchors,
                                       (cfg.crop_h, cfg.crop_w), seed=s)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    # 10. the training path (the default train_forward, "buffer": the
    # concat-free forward with its block backward): counts set to 0 just
    # before each step, read after
    state = TR.create_state(cfg, device=dev, seed=seed + 40)
    model = state.model
    # (B, H, W, Cin, Cout) of every fused conv of one step: each block's
    # layers at its map, the bottleneck's 48 channels -> growth
    seen = [(REG_BATCH, cfg.crop_h >> i, cfg.crop_w >> i, 4 * cfg.growth_rate, cfg.growth_rate)
            for i, n_layers in enumerate(cfg.block_config) for _ in range(n_layers)]
    batches = [make_batch(seed + 200 + i) for i in range(REG_STEPS)]
    log(f"[rtrain] create_state: {sum(p.numel() for p in model.parameters())} parameters, "
        f"train_forward {cfg.train_forward}, "
        f"batch {REG_BATCH}, crop {cfg.crop_h}x{cfg.crop_w}, blocks {cfg.block_config}, "
        f"growth {cfg.growth_rate}, {cfg.anchors.regression_anchors} anchors, Sinkhorn blur "
        f"{cfg.sinkhorn.blur} x{cfg.sinkhorn.n_iters}")
    totals = dict.fromkeys(names, 0)
    stat_names = [n for n, _ in model.named_buffers() if n.endswith("running_var")]
    for step in range(REG_STEPS):
        before = [p.detach().clone() for p in model.parameters()]
        var_before = [b_.clone() for n, b_ in model.named_buffers() if n in stat_names]
        for w_ in wrappers.values():
            w_.launches = 0
        metrics = TR.train_step(state, batches[step])
        torch.cuda.synchronize()
        got = {n: wrappers[n].launches for n in names}
        if got != EXPECTED_REG_STEP:
            raise AssertionError(f"regression step {step}: launches {got}, "
                                 f"expected {EXPECTED_REG_STEP}")
        for n in names:
            totals[n] += got[n]
        if set(metrics) != REG_METRICS:
            raise AssertionError(f"regression step {step}: metric keys {sorted(metrics)}")
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"regression step {step}: non-finite {bad}")
        moved = sum(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
        var_after = [b_ for n, b_ in model.named_buffers() if n in stat_names]
        if moved == 0 or any(torch.equal(a, b_) for a, b_ in zip(var_before, var_after)):
            raise AssertionError(f"regression step {step}: {moved} parameters moved, or a "
                                 f"running variance did not change")
        log(f"[rtrain] step {step}: " + ", ".join(f"{k} {v.item():.6g}"
                                                  for k, v in sorted(metrics.items()))
            + f"; parameters moved {moved}/{len(before)}")
    del before
    if len(seen) != EXPECTED_REG_STEP["dense_conv_fwd"]:
        raise AssertionError(f"{len(seen)} dense layers, expected 48")
    log(f"[rtrain] {REG_STEPS} steps, kernel launches {totals} ({EXPECTED_REG_STEP} per "
        f"step); every running variance changed in every step")
    fall = [TR.train_step(state, batches[0])["loss"].item() for _ in range(REG_FALL_STEPS)]
    if not all(np.isfinite(fall)) or fall[-1] >= fall[0]:
        raise AssertionError(f"loss did not fall on one batch: {fall}")
    log(f"[rtrain] {REG_FALL_STEPS} steps on one batch: loss " + " ".join(f"{v:.5g}" for v in fall))

    # 11. every dense-layer kernel against its plain version: the path's
    # shapes at batch 2 and 16, and ragged ones (h = 8; 10x12 with cin 5 -> 3)
    per_step = {s_[1:]: seen.count(s_) for s_ in sorted(set(seen))}
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    worst = {n: {"float32": 0.0, "bf16_rel": 0.0} for n in names}

    def dense_inputs(b, h, w, cin, cout):
        x = torch.randn(b, h, w, cin, device=dev, generator=gen)
        a = torch.rand(cin, device=dev, generator=gen) + 0.5
        b_ = torch.randn(cin, device=dev, generator=gen) * 0.3
        k = torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5
        # the cotangent of a loss averaged over the output: dK, da, db stay O(1)
        g = torch.randn(b, h, w, cout, device=dev, generator=gen) / (b * h * w) ** 0.5
        return x, a, b_, k, g

    def pairs(x, a, b_, k, g):
        return {
            "dense_conv_fwd": (lambda: DK.dense_conv_fwd(x, a, b_, k),
                               lambda: DC.conv3x3_nhwc_reference(x, a, b_, k)),
            "dense_conv_dx": (lambda: DK.dense_conv_dx(g, x, a, k),
                              lambda: DC.conv3x3_dx_plain(g, x, a, k)),
            "dense_conv_dk": (lambda: DK.dense_conv_dk(x, g, a, b_),
                              lambda: DC.conv3x3_dk_plain(x, g, a, b_)),
        }

    def check(shape, inputs):
        x, a, b_, k, g = inputs
        for dt in ("float32", "bfloat16"):
            cast = getattr(torch, dt)
            for name, (kern, plain) in pairs(x.to(cast), a, b_, k.to(cast), g.to(cast)).items():
                outs, refs = kern(), plain()
                torch.cuda.synchronize()
                outs = outs if isinstance(outs, tuple) else (outs,)
                refs = refs if isinstance(refs, tuple) else (refs,)
                for i, (out, ref) in enumerate(zip(outs, refs)):
                    err = (out - ref).abs().max().item()
                    if dt == "float32":
                        # dK, da and db are long sums over pixels: rtol 1e-3
                        rtol = 1e-3 if name == "dense_conv_dk" or i > 0 else 1e-4
                        torch.testing.assert_close(out, ref, rtol=rtol, atol=1e-4,
                                                   msg=lambda m: f"{name}[{i}] {shape}: {m}")
                        worst[name]["float32"] = max(worst[name]["float32"], err)
                    else:
                        scale = ref.abs().max().item()
                        if err > 2e-2 * scale:
                            raise AssertionError(f"{name}[{i}] bf16 {shape}: {err} > 2e-2 * {scale}")
                        worst[name]["bf16_rel"] = max(worst[name]["bf16_rel"], err / scale)

    check_shapes = ([(2, *s_) for s_ in per_step] + [(REG_BATCH, *s_) for s_ in per_step]
                    + [(2, 8, 16, 48, 12), (2, 10, 12, 5, 3)])
    for shape in check_shapes:
        check(shape, dense_inputs(*shape))
    log(f"[rcheck] B7, B7' (dx, da, db), B8 against their plain versions at {check_shapes}: "
        + "; ".join(f"{n} f32 max|err| {worst[n]['float32']:.3e}, bf16 "
                    f"{worst[n]['bf16_rel']:.3e} of max|ref|" for n in names))

    # 12. timing at the path's batch: kernel, plain version, bound and the
    # cuDNN call on the same problem (channels_last; it gets y precomputed,
    # so it leaves out the affine, and in dx the post-scale and dA/dB)
    rows = []
    for (h, w, cin, cout), n_step in per_step.items():
        x, a, b_, k, g = dense_inputs(REG_BATCH, h, w, cin, cout)
        y_cl = (x * a + b_).permute(0, 3, 1, 2)  # NHWC in memory: channels_last
        g_cl = g.permute(0, 3, 1, 2)
        w_cl = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library = {
            "dense_conv_fwd": lambda: F.conv2d(y_cl, w_cl, padding=1),
            "dense_conv_dx": lambda: torch.nn.grad.conv2d_input(
                (REG_BATCH, cin, h, w), w_cl, g_cl, padding=1),
            "dense_conv_dk": lambda: torch.nn.grad.conv2d_weight(
                y_cl, tuple(w_cl.shape), g_cl, padding=1),
        }
        for name, (kern, plain) in pairs(x, a, b_, k, g).items():
            kind = name.rsplit("_", 1)[1]
            bound, bound_by = dense_bound_ms(kind, REG_BATCH, h, w, cin, cout)
            row = {"kernel": name, "shape": [REG_BATCH, h, w, cin, cout], "per_step": n_step,
                   "ms": cuda_ms(torch, kern, warmup=1, iters=5),
                   "plain_ms": cuda_ms(torch, plain, warmup=1, iters=5),
                   "library_ms": cuda_ms(torch, library[name], warmup=1, iters=5),
                   "bound_ms": bound, "bound_by": bound_by,
                   "tc_bound_ms": dense_bound_ms(kind, REG_BATCH, h, w, cin, cout, tc=True)[0]}
            rows.append(row)
            log(f"[rtiming] {name} B{REG_BATCH} {h}x{w} {cin}->{cout} x{n_step}/step: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN "
                f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.3f}x), bound "
                f"{bound:.4f} ms ({bound_by}), tc bound {row['tc_bound_ms']:.4f} ms")
        del x, a, b_, k, g, y_cl, g_cl, w_cl
    per_kernel = {}
    for n in names:
        sel = [r for r in rows if r["kernel"] == n]
        per = {key: sum(r[key] * r["per_step"] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "tc_bound_ms")}
        ops = sum(r["bound_ms"] * r["per_step"] for r in sel if r["bound_by"] == "operations")
        per["bound_by"] = "operations" if ops >= per["bound_ms"] / 2 else "bytes"
        per_kernel[n] = per
    step_ms, step_alloc = allocator_events(
        torch, lambda: cuda_ms(torch, lambda: TR.train_step(state, batches[0]), warmup=1, iters=5))
    log(f"[rtiming] batch {REG_BATCH}: train_step {step_ms:.3f} ms (allocator events over its 6 "
        f"timed steps: {step_alloc}); per step: " + "; ".join(
        f"{n} kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f}, cuDNN {v['library_ms']:.3f}, "
        f"bound {v['bound_ms']:.3f}, tc bound {v['tc_bound_ms']:.3f}"
        for n, v in per_kernel.items()))
    tables["regression_shapes"] = rows
    tables["regression_step_ms"] = step_ms
    tables["regression_step_allocator"] = step_alloc
    tables["regression_per_kernel"] = per_kernel
    prof = device_profile(torch, lambda: TR.train_step(state, batches[0]), top=12)
    if prof is None:
        log("[rtiming] the profiler saw no device work: idle share not measured")
    else:
        wall_ms, busy_ms, ranked = prof
        log(f"[rtiming] one train_step under the profiler: {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top device work:")
        for name, ms, n in ranked:
            log(f"[rtiming]   {ms:9.3f} ms  {ms / busy_ms:.4f}  x{n:<4d} {name[:100]}")
        tables["regression_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                                        "top": [list(r) for r in ranked]}
    tables["regression_routes"] = regression_routes(torch, dev, seed, cfg, batches[0], wrappers)
    save()

    entries = []
    for n in names:
        kid, source, replaces = DK.KERNELS[n]
        v = per_kernel[n]
        entries.append({
            "name": n, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
            "launches": totals[n], "max_abs_err": worst[n]["float32"],
            "max_err_f32": worst[n]["float32"], "max_err_bf16_rel": worst[n]["bf16_rel"],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "tc_bound_ms": v["tc_bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"],
        })
    return entries


def regression_routes(torch, dev, seed: int, cfg, batch: dict, wrappers: dict) -> dict:
    """Phase 12, continued: the regression step's four routes, train_forward
    "buffer" (the default: the concat-free forward, nn/densenet_fast.py) and
    "standard" (the DenseNet module's graph), each in float32 and bfloat16,
    each from one seeded state on one batch of REG_BATCH: B7, B7' and B8
    launch 48 times each per step on every route (asserted); the step's time
    (CUDA events, median of 5), its peak memory, one profiled step (idle
    share). Checks: every route's losses within 2e-2 relative of the
    float32 standard step's; the buffer step's float32 gradients against
    the standard step's, every leaf within the larger of GRAD_REL and
    GRAD_SPREAD times the standard step's own spread under a
    JITTER-relative jitter of the crop (phase 9's bar), bfloat16's worst
    leaf logged. Returns the rows by route."""
    from emlight_tpu_torch.train import regression as TR

    names = list(EXPECTED_REG_STEP)
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    jittered = dict(batch, crop=batch["crop"] * (
        1 + JITTER * torch.randn(batch["crop"].shape, device=dev, generator=gen)))
    rows, grads, losses = {}, {}, {}
    for dt in ("float32", "bfloat16"):
        for tf in ("buffer", "standard"):
            st = TR.create_state(dataclasses.replace(cfg, dtype=dt, train_forward=tf),
                                 device=dev, seed=seed + 41)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w_ in wrappers.values():
                w_.launches = 0
            metrics = TR.train_step(st, batch)
            torch.cuda.synchronize()
            got = {n: wrappers[n].launches for n in names}
            if got != EXPECTED_REG_STEP:
                raise AssertionError(f"{tf} {dt} step: launches {got}, expected "
                                     f"{EXPECTED_REG_STEP}")
            losses[(tf, dt)] = {k: v.item() for k, v in metrics.items()}
            grads[(tf, dt)] = {n: p.grad.float().clone() for n, p in st.model.named_parameters()}
            row = {"launches": got, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "ms": cuda_ms(torch, lambda: TR.train_step(st, batch), warmup=1, iters=5)}
            prof = device_profile(torch, lambda: TR.train_step(st, batch), top=4)
            if prof is not None:
                row.update(wall_ms=prof[0], busy_ms=prof[1], idle_share=1 - prof[1] / prof[0],
                           top=[list(r) for r in prof[2]])
            rows[f"{tf}_{dt}"] = row
            del st
    ref = losses[("standard", "float32")]
    for key, lo in losses.items():
        bad = {k: (v, ref[k]) for k, v in lo.items()
               if not abs(v - ref[k]) <= 2e-2 * max(abs(ref[k]), 1e-6)}
        if bad:
            raise AssertionError(f"{key} step losses off the float32 standard step's: {bad}")
    st = TR.create_state(dataclasses.replace(cfg, train_forward="standard"), device=dev,
                         seed=seed + 41)
    TR.train_step(st, jittered)
    spread = grad_ratios({n: p.grad.float() for n, p in st.model.named_parameters()},
                         grads[("standard", "float32")])
    del st
    bar = max(GRAD_REL, GRAD_SPREAD * spread[-1][0])
    f32 = grad_ratios(grads[("buffer", "float32")], grads[("standard", "float32")])
    bf16 = grad_ratios(grads[("buffer", "bfloat16")], grads[("standard", "bfloat16")])
    bad = [r for r in f32 if r[0] > bar]
    if bad:
        raise AssertionError(f"buffer vs standard step: {len(bad)} gradient leaves above "
                             f"{bar:.3e} of their scale; worst {bad[-3:]}")
    for key, row in rows.items():
        log(f"[rroutes] train_step {key.replace('_', ' ')}, batch {REG_BATCH}: {row['ms']:.3f} ms "
            f"(CUDA events, median of 5), peak {row['peak_gib']:.2f} GiB, launches "
            f"{row['launches']}" + (f"; one step under the profiler {row['wall_ms']:.3f} ms, "
                                    f"device busy {row['busy_ms']:.3f} ms, idle share "
                                    f"{row['idle_share']:.4f}" if "busy_ms" in row else
                                    "; the profiler saw no device work"))
    log(f"[rroutes] buffer vs standard step, float32: gradient leaves against their scale, "
        f"worst {f32[-1][0]:.3e} ({f32[-1][1]}), bar {bar:.3e} (the standard step's own spread "
        f"under a {JITTER:g} relative jitter of the crop {spread[-1][0]:.3e}); bfloat16: worst "
        f"{bf16[-1][0]:.3e} ({bf16[-1][1]}), logged; losses of every route within 2e-2 of the "
        f"float32 standard step's: " + "; ".join(
            f"{tf} {dt} {lo['loss']:.6g}" for (tf, dt), lo in losses.items()))
    return {"routes": rows, "grad_worst_f32": f32[-1], "grad_bar_f32": bar,
            "grad_worst_bf16": bf16[-1], "losses": {f"{k[0]}_{k[1]}": v for k, v in losses.items()}}


def run_regression_card_vs_cpu(torch, np, dev, seed: int) -> None:
    """Phase 13: one train_step at batch 4 on a reduced config (crop 96x128,
    blocks (4, 4, 4)) on the card and on the CPU plain path from one initial
    state; the loss terms and every gradient leaf compared, the gradient bar
    measured as in phase 9: the CPU runs the step again on a crop jittered by
    JITTER relative, and each leaf of the card must lie within GRAD_SPREAD
    times the largest change that jitter makes, and never needs to lie closer
    than GRAD_REL."""
    import dataclasses

    from emlight_tpu_torch.config import RegressionConfig
    from emlight_tpu_torch.train import regression as TR
    from emlight_tpu_torch.train.data import synthetic_regression_batch

    small = dataclasses.replace(RegressionConfig(), crop_h=96, crop_w=128, batch_size=4,
                                block_config=(4, 4, 4))
    sb = synthetic_regression_batch(4, 96, (96, 128), seed=seed + 50)
    rng = np.random.default_rng(seed + 51)
    jittered = dict(sb, crop=(sb["crop"] * (1 + JITTER * rng.standard_normal(sb["crop"].shape))
                              ).astype(np.float32))
    t0 = time.perf_counter()
    runs = {"card": (dev, sb), "cpu": ("cpu", sb), "cpu jittered": ("cpu", jittered)}
    losses, grads = {}, {}
    for name, (d, batch) in runs.items():
        st = TR.create_state(small, device=d, seed=seed + 52)
        losses[name] = {k: v.item() for k, v in TR.train_step(st, batch).items()}
        grads[name] = {n: p.grad.cpu() for n, p in st.model.named_parameters()}
    loss_err = max(abs(v - losses["cpu"][k]) / max(abs(losses["cpu"][k]), 1e-6)
                   for k, v in losses["card"].items())
    if loss_err > 1e-4:
        raise AssertionError(f"card vs CPU losses differ by {loss_err} relative: {losses}")
    spread = grad_ratios(grads["cpu jittered"], grads["cpu"])
    card = grad_ratios(grads["card"], grads["cpu"])
    bar = max(GRAD_REL, GRAD_SPREAD * spread[-1][0])
    bad = [r for r in card if r[0] > bar]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(card)} gradient leaves above {bar:.3e} of "
                             f"their scale (CPU's own spread {spread[-1]}); worst {bad[-5:]}")
    log(f"[rcpu] crop 96x128, blocks (4, 4, 4), batch 4: train_step card vs CPU plain path: "
        f"losses within {loss_err:.3e} relative (bar 1e-4); gradient leaves against their "
        f"scale: worst {card[-1][0]:.3e} ({card[-1][1]}), {sum(r[0] > GRAD_REL for r in card)} "
        f"of {len(card)} above {GRAD_REL}, CPU's own spread under a {JITTER:g} relative "
        f"jitter of the crop {spread[-1][0]:.3e}, bar {bar:.3e}; took "
        f"{time.perf_counter() - t0:.1f} s")


CLI_CROPS, CLI_LARGE = 17, (3, 11)  # 17 crops: batches 8, 8, 1; crops 3 and 11 at 384x512
# the check set's EXR formats in turn: PIZ HALF (the Laval wire format), ZIP FLOAT, ZIP HALF
CLI_FORMATS = (("piz", True), ("zip", False), ("zip", True))
CLI_TIMED_BATCHES = 8  # the timed set: 8 full batches of PIZ HALF crops at 192x256


def synthetic_crop(np, rng, h: int, w: int):
    """A smooth background with a little noise, as a photograph has, and
    two Laval-scale lights."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.15 + 0.1 * np.sin(6 * xx + 2 * yy + rng.uniform(0, 6))[..., None] * [1.0, 0.8, 0.6]
    img = (img + rng.normal(0, 0.01, img.shape)).astype(np.float32)
    for _ in range(2):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 16)
        img[y:y + 12, x:x + 16] = rng.uniform(20.0, 60.0, 3)
    return img


def read_png(path: str, np):
    """A small stdlib PNG reader for the CLIs' previews: 8-bit RGB, no
    interlace, filter type 0 on every row (what core/png.py writes; another
    filter raises), one zlib stream over the IDAT chunks, CRCs checked."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = hdr
    if (depth, colour, interlace) != (8, 2, 0):
        raise AssertionError(f"{path}: not 8-bit RGB without interlace: {hdr}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def run_cli(torch, np, dev, seed: int, regressor, generator, reg_cfg, proj_cfg, smi) -> dict:
    """Phase 14: the inference CLIs on the card, at full width, from files.

    17 synthetic crops (192x256, two at 384x512; PIZ HALF, ZIP FLOAT, ZIP
    HALF in turn; HDR-range light spots) written with the port's write_exr,
    and the seeded regressor and generator, with randomized BatchNorm running
    statistics, written as JAX-layout checkpoints (save_checkpoint and the
    inverse weight maps) beside one opt.json per run. Then cli.infer.main
    with --save_pickles at batch 8 (B1's launches read around it: 44 per
    batch, 3 batches) and cli.test_regression.main with --render. Checks:
    the restored models equal the seeded ones bit for bit; every .exr map
    equals pipeline_inference on the same preprocessed crops at the same
    batches bit for bit; one crop's map against the CPU plain path at phase
    4's bar; test_regression's pickles against infer's (rtol 1e-5, atol
    1e-6); every PNG decodes (read_png) to its uint8 array. These 17 crops
    check; the timing comes from a second infer run on their own: 8 full
    batches of 8 PIZ HALF crops at 192x256 (the Laval wire format) with the
    default outputs (.exr and .png), B1's launches read around it (44 x 8):
    crops/s, host ms per crop by stage, pipeline_inference's CUDA-event span
    per batch (the card's idle gaps inside the call included)."""
    import pickle
    import shutil

    from emlight_tpu_torch.cli import _common as CC
    from emlight_tpu_torch.cli import infer as cli_infer
    from emlight_tpu_torch.cli import test_regression as cli_test_regression
    from emlight_tpu_torch.core.exr import read_exr, write_exr
    from emlight_tpu_torch.core.hdr import TONEMAP_TEST, TONEMAP_VIZ, read_hdr, resize_panorama
    from emlight_tpu_torch.nn.sphere_conv_kernel import sphere_conv_s1
    from emlight_tpu_torch.representation.splat import render_anchor_params
    from emlight_tpu_torch.train import pipeline as PL
    from emlight_tpu_torch.train import projector as PJ
    from emlight_tpu_torch.train import regression as RG
    from emlight_tpu_torch.train.checkpoint import (restore_generator, restore_regressor,
                                                    save_checkpoint)
    from emlight_tpu_torch.train.jax_weights import (densenet_tree_from_state,
                                                     generator_tree_from_state)

    t_phase = time.perf_counter()
    work = os.path.join(HERE, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    crop_dir, out_infer, out_reg = (os.path.join(work, d) for d in ("crop", "infer", "reg"))
    os.makedirs(crop_dir)

    # the models, with nontrivial running statistics (fresh ones are 0 / 1)
    regressor, generator = copy.deepcopy(regressor), copy.deepcopy(generator)
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    with torch.no_grad():
        for model in (regressor, generator):
            for name, buf in model.named_buffers():
                if name.endswith("mean"):
                    buf.copy_(torch.randn(buf.shape, device=dev, generator=gen) * 0.1)
                elif name.endswith("var"):
                    buf.copy_(torch.rand(buf.shape, device=dev, generator=gen) + 0.5)
    t0 = time.perf_counter()
    params, stats = densenet_tree_from_state(regressor.state_dict())
    reg_ckpt = save_checkpoint(os.path.join(work, "reg_run", "checkpoints"), {
        "step": np.zeros((), np.int32), "params": params, "batch_stats": stats})
    params, stats = generator_tree_from_state(generator.state_dict())
    proj_ckpt = save_checkpoint(os.path.join(work, "proj_run", "checkpoints"), {
        "step": np.zeros((), np.int32), "g_params": params, "g_stats": stats})
    del params, stats
    save_s = time.perf_counter() - t0
    with open(os.path.join(work, "reg_run", "opt.json"), "w") as f:
        json.dump({"anchors": reg_cfg.anchors.regression_anchors,
                   "block_config": ",".join(map(str, reg_cfg.block_config)),
                   "crop": f"{reg_cfg.crop_h},{reg_cfg.crop_w}", "clip_grad_norm": 0.0}, f)
    with open(os.path.join(work, "proj_run", "opt.json"), "w") as f:
        json.dump({"crop_size": proj_cfg.crop_size, "ngf": proj_cfg.ngf, "ndf": proj_cfg.ndf,
                   "dtype": proj_cfg.dtype, "clip_grad_norm": 0.0}, f)

    rng = np.random.default_rng(seed + 61)
    names, fmt_of = [], {}
    for i in range(CLI_CROPS):
        h, w = (2 * reg_cfg.crop_h, 2 * reg_cfg.crop_w) if i in CLI_LARGE else (
            reg_cfg.crop_h, reg_cfg.crop_w)
        comp, half = CLI_FORMATS[i % len(CLI_FORMATS)]
        names.append(f"crop{i:02d}.exr")
        fmt_of[names[-1]] = f"{comp}-{'half' if half else 'float'}"
        write_exr(os.path.join(crop_dir, names[-1]), synthetic_crop(np, rng, h, w), half=half,
                  compression=comp)

    # 14a. infer at batch 8, B1's launches read around it
    batches = -(-CLI_CROPS // BATCH)
    torch.cuda.synchronize()
    sphere_conv_s1.launches = 0
    st = cli_infer.main([
        "--reg_ckpt", reg_ckpt, "--proj_ckpt", proj_ckpt,
        "--reg_config", os.path.join(work, "reg_run"),
        "--proj_config", os.path.join(work, "proj_run"),
        "--crops", crop_dir, "--out_dir", out_infer, "--batch", str(BATCH), "--save_pickles"])
    torch.cuda.synchronize()
    cli_launches = sphere_conv_s1.launches
    if cli_launches != LAUNCHES_PER_FORWARD * batches:
        raise AssertionError(f"infer launched B1 {cli_launches} times, expected "
                             f"{LAUNCHES_PER_FORWARD} x {batches}")
    if st["crops"] != CLI_CROPS or st["batches"] != batches or len(st["device_ms"]) != batches:
        raise AssertionError(f"infer ran {st}")

    # 14b. test_regression (its default batch, 16) with --render
    t0 = time.perf_counter()
    cli_test_regression.main(["--ckpt", reg_ckpt, "--load_config", os.path.join(work, "reg_run"),
                              "--crops", crop_dir, "--out_dir", out_reg, "--render"])
    reg_cli_s = time.perf_counter() - t0

    # checks: the restored models
    for restored, seeded, what in (
            (restore_regressor(reg_ckpt, RG.make_model(reg_cfg, device=dev, seed=seed + 62)),
             regressor, "regressor"),
            (restore_generator(proj_ckpt, PJ.make_models(proj_cfg, device=dev, seed=seed + 63)),
             generator, "generator")):
        want = seeded.state_dict()
        for k, v in restored.state_dict().items():
            if not torch.equal(v, want[k]):
                raise AssertionError(f"restored {what} differs from the seeded one at {k}")
    # every map against pipeline_inference on the same preprocessed crops
    proj_in = proj_cfg.crop_size // 2
    preproc = {}
    for nm in names:
        img, reg_in = CC.tonemapped_crop(read_hdr(os.path.join(crop_dir, nm)),
                                         reg_cfg.crop_h, reg_cfg.crop_w)
        preproc[nm] = (reg_in, resize_panorama(img, (proj_in, proj_in)))
    envs = {}
    for s in range(0, CLI_CROPS, BATCH):
        chunk = names[s:s + BATCH]
        env, _ = PL.pipeline_inference(regressor, generator,
                                       np.stack([preproc[n][0] for n in chunk]),
                                       np.stack([preproc[n][1] for n in chunk]),
                                       reg_cfg, proj_cfg, device=dev)
        envs.update(zip(chunk, env.cpu().numpy()))
    torch.cuda.synchronize()
    for nm in names:
        stem = nm[:-len(".exr")]
        got = read_exr(os.path.join(out_infer, f"{stem}.exr"))
        if got.shape != envs[nm].shape or not np.array_equal(got, envs[nm]):
            err = np.abs(got - envs[nm]).max() if got.shape == envs[nm].shape else got.shape
            raise AssertionError(f"infer's {stem}.exr differs from pipeline_inference: {err}")
        if not np.isfinite(got).all() or got.min() < 0 or got.max() > 50:
            raise AssertionError(f"{stem}.exr not finite in [0, 50]")
        png = read_png(os.path.join(out_infer, f"{stem}.png"), np)
        if not np.array_equal(png, (TONEMAP_VIZ(got)[0] * 255).astype(np.uint8)):
            raise AssertionError(f"{stem}.png is not the uint8 TONEMAP_VIZ of its map")
    # one crop (a resized 384x512 one) on the CPU plain path, phase 4's bar
    one = names[CLI_LARGE[0]]
    reg_cpu = copy.deepcopy(regressor).to("cpu")
    gen_cpu = copy.deepcopy(generator).to("cpu")
    t0 = time.perf_counter()
    env_cpu, _ = PL.pipeline_inference(reg_cpu, gen_cpu, preproc[one][0][None],
                                       preproc[one][1][None], reg_cfg, proj_cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    del reg_cpu, gen_cpu
    cpu_err = np.abs(envs[one] - env_cpu[0].numpy()).max()
    np.testing.assert_allclose(envs[one], env_cpu[0].numpy(), rtol=1e-3, atol=1e-2)
    # test_regression's pickles against infer's, and its previews
    pred_err = 0.0
    for nm in names:
        stem = nm[:-len(".exr")]
        with open(os.path.join(out_reg, f"{stem}.pickle"), "rb") as f:
            para = pickle.load(f)
        with open(os.path.join(out_infer, f"{stem}.pickle"), "rb") as f:
            ref = pickle.load(f)
        if list(para) != list(ref) or any(type(para[k]) is not type(ref[k]) for k in ref):
            raise AssertionError(f"{stem}.pickle: keys or types differ between the CLIs")
        for k in ref:
            np.testing.assert_allclose(para[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=f"{stem} {k}")
            pred_err = max(pred_err, float(np.abs(para[k] - ref[k]).max()))
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
        env = render_anchor_params(torch.softmax(as_t(para["distribution"]), -1)[None],
                                   as_t([para["intensity"]]), as_t(para["rgb_ratio"][None]),
                                   n=reg_cfg.anchors.regression_anchors,
                                   intensity_scale=reg_cfg.anchors.intensity_scale)
        want = (TONEMAP_TEST(np.maximum(env.cpu().numpy()[0], 0.0))[0] * 255).astype(np.uint8)
        if not np.array_equal(read_png(os.path.join(out_reg, f"{stem}_env.png"), np), want):
            raise AssertionError(f"{stem}_env.png is not its render's uint8 TONEMAP_TEST")

    # 14c. the timed set: full batches in the Laval wire format, default outputs
    timed_dir, out_timed = os.path.join(work, "timed_crop"), os.path.join(work, "timed")
    os.makedirs(timed_dir)
    n_timed = CLI_TIMED_BATCHES * BATCH
    for i in range(n_timed):
        write_exr(os.path.join(timed_dir, f"crop{i:02d}.exr"),
                  synthetic_crop(np, rng, reg_cfg.crop_h, reg_cfg.crop_w), half=True,
                  compression="piz")
    torch.cuda.synchronize()
    sphere_conv_s1.launches = 0
    tm = cli_infer.main([
        "--reg_ckpt", reg_ckpt, "--proj_ckpt", proj_ckpt,
        "--reg_config", os.path.join(work, "reg_run"),
        "--proj_config", os.path.join(work, "proj_run"),
        "--crops", timed_dir, "--out_dir", out_timed, "--batch", str(BATCH)])
    torch.cuda.synchronize()
    if sphere_conv_s1.launches != LAUNCHES_PER_FORWARD * CLI_TIMED_BATCHES:
        raise AssertionError(f"the timed infer launched B1 {sphere_conv_s1.launches} times, "
                             f"expected {LAUNCHES_PER_FORWARD} x {CLI_TIMED_BATCHES}")
    if tm["crops"] != n_timed or len(tm["device_ms"]) != CLI_TIMED_BATCHES:
        raise AssertionError(f"the timed infer ran {tm}")
    for i in range(n_timed):
        got = read_exr(os.path.join(out_timed, f"crop{i:02d}.exr"))
        if got.shape != envs[names[0]].shape or not np.isfinite(got).all():
            raise AssertionError(f"the timed infer's crop{i:02d}.exr is not a finite map")

    # read_hdr by format, on the check set's regressor-sized crops
    read_ms = {}
    for nm in names:
        if names.index(nm) not in CLI_LARGE:
            t0 = time.perf_counter()
            read_hdr(os.path.join(crop_dir, nm))
            read_ms.setdefault(fmt_of[nm], []).append((time.perf_counter() - t0) * 1e3)
    read_ms = {k: statistics.median(v) for k, v in read_ms.items()}
    n = tm["crops"]
    out = {
        "crops": n, "batch": BATCH, "batches": tm["batches"], "format": "piz-half",
        "b1_launches": cli_launches, "timed_b1_launches": LAUNCHES_PER_FORWARD * tm["batches"],
        "crops_per_s": n / tm["loop_s"], "loop_s": tm["loop_s"],
        "setup_s": tm["wall_s"] - tm["loop_s"],
        "read_ms_per_crop": 1e3 * tm["read_s"] / n, "prep_ms_per_crop": 1e3 * tm["prep_s"] / n,
        "write_ms_per_crop": 1e3 * tm["write_s"] / n,
        "pipeline_host_ms_per_batch": 1e3 * tm["pipeline_s"] / tm["batches"],
        "pipeline_span_ms_per_batch": tm["device_ms"],
        # CUDA-event spans around pipeline_inference: the card's idle gaps
        # inside the call count too, so this is not the card's busy share
        "pipeline_span_share": sum(tm["device_ms"]) / 1e3 / tm["loop_s"],
        "host_io_share": (tm["read_s"] + tm["prep_s"] + tm["write_s"]) / tm["loop_s"],
        "read_ms_by_format": read_ms, "check_set_loop_s": st["loop_s"],
        "test_regression_s": reg_cli_s,
        "checkpoint_save_s": save_s, "checkpoint_mb": os.path.getsize(proj_ckpt) / 2**20,
    }
    hw = f"{reg_cfg.crop_h}x{reg_cfg.crop_w}"
    spans = sorted(tm["device_ms"])
    log(f"[cli] {smi}: infer, timed set: {n} PIZ HALF crops of {hw}, {tm['batches']} batches "
        f"of {BATCH}, .exr + .png out, from JAX-layout checkpoints: {out['crops_per_s']:.3f} "
        f"crops/s over the loop ({tm['loop_s']:.3f} s; set-up {out['setup_s']:.3f} s: models, "
        f"checkpoint read of {out['checkpoint_mb']:.1f} MB for G); B1 launches "
        f"{out['timed_b1_launches']}")
    log(f"[cli] {smi}: timed set, host ms per crop: read {out['read_ms_per_crop']:.3f}, tonemap "
        f"+ resize {out['prep_ms_per_crop']:.3f}, write (exr, png) "
        f"{out['write_ms_per_crop']:.3f}; pipeline_inference "
        f"{out['pipeline_host_ms_per_batch']:.3f} ms per batch on the host clock, its CUDA-event span per batch median "
        f"{statistics.median(spans):.3f} (min {spans[0]:.3f}, max {spans[-1]:.3f}); span share "
        f"of the loop {out['pipeline_span_share']:.4f} (idle gaps inside the call included), "
        f"host I/O share {out['host_io_share']:.4f}")
    log(f"[cli] {smi}: check set ({CLI_CROPS} crops, formats mixed, with pickles): B1 launches "
        f"{cli_launches} ({LAUNCHES_PER_FORWARD} x {batches} batches), loop {st['loop_s']:.3f} s;"
        f" read_hdr per {hw} crop by format (median ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in read_ms.items())
        + f"; checkpoints written in {save_s:.3f} s; test_regression --render "
        f"{reg_cli_s:.3f} s")
    log(f"[cli] checks: restored models equal the seeded ones; {CLI_CROPS} maps equal "
        f"pipeline_inference bit for bit, finite in [0, 50]; {one} card vs CPU plain path "
        f"max|err| {cpu_err:.3e} (rtol 1e-3, atol 1e-2; CPU {cpu_s:.1f} s); test_regression "
        f"pickles vs infer's max|diff| {pred_err:.3e} (rtol 1e-5, atol 1e-6); {2 * CLI_CROPS} "
        f"PNGs decode to their uint8 arrays; the timed set's {n} maps finite; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    # phase 16b serves these files again with --parallel, then removes them
    out["files"] = {"work": work, "reg_ckpt": reg_ckpt, "proj_ckpt": proj_ckpt,
                    "reg_run": os.path.join(work, "reg_run"),
                    "proj_run": os.path.join(work, "proj_run"), "crop_dir": crop_dir}
    return out


TCLI_SAMPLES = 32  # crops and warped panoramas of the synthetic Laval-layout root
TCLI_PROJ_BATCH = 8  # train_projector's batch, cut from 16 for the run's time (as phase 6's)


def write_laval_roots(np, rng, work: str, reg_cfg, proj_cfg) -> tuple[str, str]:
    """Two synthetic Laval-layout roots at full width, every image PIZ HALF
    (the Laval wire format): TCLI_SAMPLES crops at the regressor's 192x256
    and as many warped panoramas at the generator's 128x256, each with
    Laval-scale lights (synthetic_crop); GT pickles with the regressor's 96
    anchors in the first root, the projector's 128 in the second, which
    shares the crops (a symlink). Returns (regression root, projector root)."""
    import pickle

    from emlight_tpu_torch.core.exr import write_exr

    reg_root, proj_root = os.path.join(work, "laval_reg"), os.path.join(work, "laval_proj")
    for d in ("crop", "pkl"):
        os.makedirs(os.path.join(reg_root, d))
    for d in ("warped", "pkl"):
        os.makedirs(os.path.join(proj_root, d))
    os.symlink(os.path.join(reg_root, "crop"), os.path.join(proj_root, "crop"))
    env_h, env_w = proj_cfg.crop_size // 2, proj_cfg.crop_size
    for i in range(TCLI_SAMPLES):
        name = f"scene{i:02d}"
        write_exr(os.path.join(reg_root, "crop", f"{name}.exr"),
                  synthetic_crop(np, rng, reg_cfg.crop_h, reg_cfg.crop_w), half=True,
                  compression="piz")
        write_exr(os.path.join(proj_root, "warped", f"{name}.exr"),
                  synthetic_crop(np, rng, env_h, env_w), half=True, compression="piz")
        for root, n in ((reg_root, reg_cfg.anchors.regression_anchors),
                        (proj_root, proj_cfg.anchors.n_anchors)):
            dist = rng.gamma(0.3, 1.0, n).astype(np.float32)
            rgb = rng.uniform(0.4, 0.7, 3).astype(np.float32)
            gt = {"distribution": dist / dist.sum(),
                  "intensity": np.float32(rng.uniform(100.0, 1000.0)),
                  "rgb_ratio": rgb / np.linalg.norm(rgb),
                  "ambient": (rng.uniform(0.05, 0.3, 3) * 128 * 256).astype(np.float32)}
            with open(os.path.join(root, "pkl", f"{name}.pickle"), "wb") as f:
                pickle.dump(gt, f)
    return reg_root, proj_root


def run_train_cli(torch, np, dev, seed: int, tables: dict, smi) -> dict:
    """Phase 15: training and evaluation from files on the card, at full width.

    A synthetic Laval-layout dataset (write_laval_roots), then:
    cli.train_regression at RegressionConfig() (batch 16, 2 steps an epoch)
    for 1 epoch and again with --resume --epochs 2 and no shape flags (its
    opt.json supplies them); cli.train_projector at ProjectorConfig()'s
    width (batch TCLI_PROJ_BATCH, 4 G+D steps an epoch) likewise; then
    cli.test_projector, cli.eval_projector and cli.eval_metrics on the
    final checkpoints. Each kernel's launches are read around each CLI: B7,
    B7' and B8 48 each per regression step, the sphere-conv kernels
    EXPECTED_G_STEP + EXPECTED_D_STEP per G+D step, B1 44 per test_projector
    or eval_projector batch. Checks: every resumed run starts at the saved
    step; a fresh train state restored from each first run's checkpoint
    gives back that file's every leaf bit for bit (parameters, BatchNorm
    statistics, spectral u and v, Adam moments and counts); metrics.csv has
    one finite row per step; test_projector's maps equal inference on the
    same batches bit for bit; the eval JSON lines are finite. Then
    cli.train_projector --scan_steps SCAN_STEPS --vgg_random for an epoch
    and --resume --fused to the next (EXPECTED_FUSED_STEP per step; the
    resumed run starts at the saved step; metrics.csv rows with VGG).
    Times: each training loop's median step (CUDA events) beside phase 8's,
    9b's or 12's step, its wait on the data queue per step and that wait's
    share of the loop, and read_hdr per PIZ HALF crop, native beside
    core/exr.py."""
    import csv
    import math
    import shutil

    from emlight_tpu_torch.cli import _common as CC
    from emlight_tpu_torch.cli import eval_metrics as cli_eval_metrics
    from emlight_tpu_torch.cli import eval_projector as cli_eval_projector
    from emlight_tpu_torch.cli import test_projector as cli_test_projector
    from emlight_tpu_torch.cli import train_projector as cli_train_projector
    from emlight_tpu_torch.cli import train_regression as cli_train_regression
    from emlight_tpu_torch.config import ProjectorConfig, RegressionConfig
    from emlight_tpu_torch.core.exr import read_exr
    from emlight_tpu_torch.core.hdr import read_hdr
    from emlight_tpu_torch.nn import dense_conv_kernel as DK
    from emlight_tpu_torch.nn import sphere_conv_kernel as SK
    from emlight_tpu_torch.train import projector as PJ
    from emlight_tpu_torch.train import regression as RG
    from emlight_tpu_torch.train.checkpoint import (read_checkpoint, restore_generator,
                                                    restore_train_state, train_state_tree)
    from emlight_tpu_torch.train.data import ProjectorDataset

    t_phase = time.perf_counter()
    work = os.path.join(HERE, "build", "tcli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    reg_cfg = RegressionConfig()
    proj_cfg = dataclasses.replace(ProjectorConfig(), batch_size=TCLI_PROJ_BATCH)
    t0 = time.perf_counter()
    reg_root, proj_root = write_laval_roots(np, np.random.default_rng(seed + 70), work, reg_cfg,
                                            proj_cfg)
    write_s = time.perf_counter() - t0
    wrappers = {**{n: getattr(DK, n) for n in EXPECTED_REG_STEP},
                **{n: getattr(SK, n) for n in EXPECTED_G_STEP}}
    launches: dict = dict.fromkeys(wrappers, 0)

    def counted(main, argv):
        torch.cuda.synchronize()
        for w_ in wrappers.values():
            w_.launches = 0
        t0 = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        got = {n: w_.launches for n, w_ in wrappers.items()}
        for n, v in got.items():
            launches[n] += v
        return out, got, time.perf_counter() - t0

    def same_tree(a, b, where):
        if isinstance(a, dict):
            if set(a) != set(b):
                raise AssertionError(f"{where}: keys {sorted(set(a) ^ set(b))[:4]} differ")
            for k in a:
                same_tree(a[k], b[k], f"{where}/{k}")
        else:
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"{where}: the restored leaf differs from the file's")

    def metrics_rows(run_dir, steps):
        with open(os.path.join(run_dir, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        if [int(r["step"]) for r in rows] != list(range(1, steps + 1)):
            raise AssertionError(f"{run_dir}/metrics.csv: steps "
                                 f"{[r['step'] for r in rows]}, expected 1..{steps}")
        for r in rows:
            if not all(math.isfinite(float(v)) for v in r.values()):
                raise AssertionError(f"{run_dir}/metrics.csv: a non-finite value in {r}")
        return rows

    def expect(got, per_step, steps, what):
        want = {n: per_step.get(n, 0) * steps for n in wrappers}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")

    out: dict = {"write_dataset_s": write_s}
    # 15a. regression training, 1 epoch, then resumed to 2 from opt.json
    reg_run = os.path.join(work, "reg_run")
    reg_steps = TCLI_SAMPLES // reg_cfg.batch_size
    runs = []
    for argv in (["--data_root", reg_root, "--out_dir", reg_run, "--epochs", "1",
                  "--batch_size", str(reg_cfg.batch_size)],
                 ["--data_root", reg_root, "--out_dir", reg_run, "--epochs", "2", "--resume"]):
        st, got, wall = counted(cli_train_regression.main, argv)
        expect(got, EXPECTED_REG_STEP, reg_steps, f"train_regression {argv[-2:]}")
        runs.append((st, wall))
        if len(runs) == 1:  # the first run's checkpoint, restored into a fresh state
            ckpt = os.path.join(reg_run, "checkpoints", "latest.msgpack")
            fresh = RG.create_state(reg_cfg, device=dev, seed=seed + 71)
            same_tree(read_checkpoint(ckpt),
                      train_state_tree(restore_train_state(ckpt, fresh)), "regression")
            del fresh
    (r1, w1), (r2, w2) = runs
    if (r1["start"], r1["step"], r2["restored"], r2["start"], r2["step"]) != (
            0, reg_steps, reg_steps, reg_steps, 2 * reg_steps):
        raise AssertionError(f"train_regression steps: {r1['step']} then resumed at "
                             f"{r2['restored']}/{r2['start']} to {r2['step']}")
    metrics_rows(reg_run, 2 * reg_steps)
    out["train_regression"] = {"runs_s": [w1, w2], "step_ms": r1["step_ms"] + r2["step_ms"],
                               "wait_s": r1["wait_s"] + r2["wait_s"],
                               "loop_s": r1["loop_s"] + r2["loop_s"]}
    # one --dtype bfloat16 run, 1 epoch from scratch
    bf16_run = os.path.join(work, "reg_bf16_run")
    rb, got, wb = counted(cli_train_regression.main, [
        "--data_root", reg_root, "--out_dir", bf16_run, "--epochs", "1", "--dtype", "bfloat16"])
    expect(got, EXPECTED_REG_STEP, reg_steps, "train_regression --dtype bfloat16")
    metrics_rows(bf16_run, reg_steps)
    out["train_regression_bf16"] = {"runs_s": [wb], "step_ms": rb["step_ms"],
                                    "wait_s": rb["wait_s"], "loop_s": rb["loop_s"]}

    # 15b. GAN training, 1 epoch, then resumed to 2 from opt.json
    proj_run = os.path.join(work, "proj_run")
    proj_steps = TCLI_SAMPLES // TCLI_PROJ_BATCH
    pair = {n: EXPECTED_G_STEP[n] + EXPECTED_D_STEP[n] for n in EXPECTED_G_STEP}
    runs = []
    for argv in (["--data_root", proj_root, "--out_dir", proj_run, "--epochs", "1",
                  "--batch_size", str(TCLI_PROJ_BATCH)],
                 ["--data_root", proj_root, "--out_dir", proj_run, "--epochs", "2", "--resume"]):
        st, got, wall = counted(cli_train_projector.main, argv)
        expect(got, pair, proj_steps, f"train_projector {argv[-2:]}")
        runs.append((st, wall))
        if len(runs) == 1:
            ckpt = os.path.join(proj_run, "checkpoints", "latest.msgpack")
            fresh = PJ.create_state(proj_cfg, device=dev, seed=seed + 72,
                                    steps_per_epoch=proj_steps)
            same_tree(read_checkpoint(ckpt),
                      train_state_tree(restore_train_state(ckpt, fresh)), "projector")
            if fresh.d_step != proj_steps:
                raise AssertionError(f"restored d_step {fresh.d_step}, expected {proj_steps}")
            del fresh
    (p1, v1), (p2, v2) = runs
    if (p1["start"], p1["step"], p2["restored"], p2["start"], p2["step"]) != (
            0, proj_steps, proj_steps, proj_steps, 2 * proj_steps):
        raise AssertionError(f"train_projector steps: {p1['step']} then resumed at "
                             f"{p2['restored']}/{p2['start']} to {p2['step']}")
    metrics_rows(proj_run, 2 * proj_steps)
    out["train_projector"] = {"runs_s": [v1, v2], "step_ms": p1["step_ms"] + p2["step_ms"],
                              "wait_s": p1["wait_s"] + p2["wait_s"],
                              "loop_s": p1["loop_s"] + p2["loop_s"]}

    # 15b'. the rest of GAN training from files: --scan_steps SCAN_STEPS
    # --vgg_random for an epoch, then --resume --fused to the next
    vgg_run = os.path.join(work, "proj_vgg_run")
    for what, argv in (
            ("train_projector_scan", ["--data_root", proj_root, "--out_dir", vgg_run,
                                      "--epochs", "1", "--batch_size", str(TCLI_PROJ_BATCH),
                                      "--scan_steps", str(SCAN_STEPS), "--vgg_random"]),
            ("train_projector_fused", ["--data_root", proj_root, "--out_dir", vgg_run,
                                       "--epochs", "2", "--resume", "--fused",
                                       "--scan_steps", "0"])):
        st, got, wall = counted(cli_train_projector.main, argv)
        expect(got, EXPECTED_FUSED_STEP, proj_steps, what)
        out[what] = {"runs_s": [wall], "step_ms": st["step_ms"], "wait_s": st["wait_s"],
                     "loop_s": st["loop_s"], "steps": (st["restored"], st["start"], st["step"])}
    if (out["train_projector_scan"]["steps"], out["train_projector_fused"]["steps"]) != (
            (None, 0, proj_steps), (proj_steps, proj_steps, 2 * proj_steps)):
        raise AssertionError(f"train_projector --scan_steps then --resume --fused: (restored, "
                             f"start, step) {out['train_projector_scan']['steps']}, "
                             f"{out['train_projector_fused']['steps']}")
    vgg_rows = metrics_rows(vgg_run, 2 * proj_steps)
    if not all(float(r["VGG"]) > 0 for r in vgg_rows):
        raise AssertionError(f"{vgg_run}/metrics.csv: a row without the VGG term")

    # 15c. test_projector, eval_projector, eval_metrics on the final checkpoints
    proj_ckpt = os.path.join(proj_run, "checkpoints", "latest.msgpack")
    reg_ckpt = os.path.join(reg_run, "checkpoints", "latest.msgpack")
    tp_out = os.path.join(work, "test_projector")
    batches = -(-TCLI_SAMPLES // 8)
    _, got, tp_s = counted(cli_test_projector.main, [
        "--ckpt", proj_ckpt, "--data_root", proj_root, "--load_config", proj_run,
        "--out_dir", tp_out])
    expect(got, {"sphere_conv_s1": LAUNCHES_PER_FORWARD}, batches, "test_projector")
    generator = restore_generator(proj_ckpt, PJ.make_models(proj_cfg, device=dev))
    ds = ProjectorDataset(proj_root, crop_size=proj_cfg.crop_size // 2)
    for s in range(0, len(ds), 8):
        samples = [ds[i] for i in range(s, min(s + 8, len(ds)))]
        fake = PJ.inference(generator, CC.stacked(samples, dev),
                            proj_cfg).float().cpu().numpy()
        for i, smp in enumerate(samples):
            got_map = read_exr(os.path.join(tp_out, f"{smp['name']}.exr"))
            if not np.array_equal(got_map, fake[i]) or not np.isfinite(got_map).all():
                raise AssertionError(f"test_projector's {smp['name']}.exr differs from "
                                     f"inference on the same batch")
    del generator
    ep, got, ep_s = counted(cli_eval_projector.main, [
        "--ckpt", proj_ckpt, "--data_root", proj_root, "--load_config", proj_run])
    expect(got, {"sphere_conv_s1": LAUNCHES_PER_FORWARD}, batches, "eval_projector")
    em, got, em_s = counted(cli_eval_metrics.main, [
        "--ckpt", reg_ckpt, "--data_root", reg_root, "--load_config", reg_run])
    # --eval_apply fast (the default): B7 once per dense layer per batch of 16
    expect(got, {"dense_conv_fwd": EXPECTED_REG_STEP["dense_conv_fwd"]}, -(-TCLI_SAMPLES // 16),
           "eval_metrics")
    for what, summary in (("eval_projector", ep), ("eval_metrics", em)):
        vals = [v for k, m in summary.items() if k != "n_samples" for v in m.values()]
        if summary["n_samples"] != TCLI_SAMPLES or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: {summary}")
    out.update(test_projector_s=tp_s, eval_projector_s=ep_s, eval_metrics_s=em_s,
               eval_projector=ep, eval_metrics=em)

    # read_hdr per PIZ HALF crop: native (the path) beside core/exr.py (the oracle)
    crops = sorted(os.listdir(os.path.join(reg_root, "crop")))[:8]
    read_ms = {"native": [], "python": []}
    for nm in crops:
        path = os.path.join(reg_root, "crop", nm)
        for what, fn in (("native", read_hdr), ("python", read_exr)):
            t0 = time.perf_counter()
            img = fn(path)
            read_ms[what].append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(read_hdr(path), img):
            raise AssertionError(f"{nm}: the native reader differs from core/exr.py")
    out["read_ms_piz_half"] = {k: statistics.median(v) for k, v in read_ms.items()}
    out["launches"] = launches

    hw = f"{reg_cfg.crop_h}x{reg_cfg.crop_w}"
    for cli, ref_ms, ref_what in (
            ("train_regression", tables["regression_step_ms"], "phase 12's train_step"),
            ("train_regression_bf16",
             tables["regression_routes"]["routes"]["buffer_bfloat16"]["ms"],
             "phase 12's bf16 buffer train_step"),
            ("train_projector", tables["train_steps_ms"]["G"] + tables["train_steps_ms"]["D"],
             "phase 8's G + D step"),
            ("train_projector_scan", tables["gan"]["scan_ms_per_step"],
             f"phase 9b's scanned step (--scan_steps {SCAN_STEPS} --vgg_random)"),
            ("train_projector_fused", tables["gan"]["fused_ms"],
             "phase 9b's fused step with VGG (--resume --fused)")):
        r = out[cli]
        n = len(r["step_ms"])
        r["median_step_ms"] = statistics.median(r["step_ms"])
        # the waits before each step (the last, which found the queue empty, left out)
        waits = r["wait_s"][:n] if len(r["wait_s"]) > n else r["wait_s"]
        r["wait_ms_per_step"] = 1e3 * sum(waits) / n
        r["wait_share"] = sum(r["wait_s"]) / r["loop_s"]
        log(f"[tcli] {smi}: {cli} from files, {n} steps in {len(r['runs_s'])} run(s) ("
            + ", ".join(f"{x:.3f} s" for x in r["runs_s"]) + f"): step median "
            f"{r['median_step_ms']:.3f} ms "
            f"(CUDA events; min {min(r['step_ms']):.3f}, max {max(r['step_ms']):.3f}) beside "
            f"{ref_what} {ref_ms:.3f} ms; wait on the data queue {r['wait_ms_per_step']:.3f} ms "
            f"per step, {r['wait_share']:.4f} of the loop ({r['loop_s']:.3f} s)")
    log(f"[tcli] {smi}: read_hdr per {hw} PIZ HALF crop (median of {len(crops)}): native "
        f"{out['read_ms_piz_half']['native']:.3f} ms, core/exr.py "
        f"{out['read_ms_piz_half']['python']:.3f} ms; test_projector {tp_s:.3f} s, "
        f"eval_projector {ep_s:.3f} s, eval_metrics {em_s:.3f} s ({TCLI_SAMPLES} samples); "
        f"dataset written in {write_s:.1f} s")
    log(f"[tcli] launches over the phase: {launches}; per regression step {EXPECTED_REG_STEP}, "
        f"per G+D step {pair}, B1 {LAUNCHES_PER_FORWARD} per test_projector / eval_projector "
        f"batch ({batches} batches each), B7 48 per eval_metrics batch")
    log(f"[tcli] train_projector --scan_steps {SCAN_STEPS} --vgg_random for an epoch, then "
        f"--resume --fused: launches {SCAN_STEPS} x EXPECTED_FUSED_STEP per epoch, the resumed "
        f"run starts at step {proj_steps}, metrics.csv {2 * proj_steps} finite rows with VGG "
        f"(last {float(vgg_rows[-1]['VGG']):.5g})")
    log(f"[tcli] checks: resumed runs start at the saved step ({reg_steps}, {proj_steps}); "
        f"restored states equal their files bit for bit; metrics.csv {2 * reg_steps} and "
        f"{2 * proj_steps} finite rows; test_projector's {TCLI_SAMPLES} maps equal inference "
        f"bit for bit; eval JSON lines finite: eval_projector env_rmse mean "
        f"{ep['env_rmse']['mean']:.4f}, eval_metrics env_rmse mean "
        f"{em['env_rmse']['mean']:.4f}; phase took {time.perf_counter() - t_phase:.1f} s")
    # phase 16b trains and serves from these roots again with --parallel, then
    # removes them
    out["files"] = {"work": work, "reg_root": reg_root, "proj_root": proj_root,
                    "proj_run": proj_run, "proj_ckpt": proj_ckpt}
    return out


EXTRACT_PANOS, EXTRACT_BATCH = 64, 16  # phase 16: 4 batches of 16 warped panoramas


def run_extract(torch, np, dev, seed: int, smi) -> dict:
    """Phase 16: anchor-GT extraction from files on the card.

    EXTRACT_PANOS synthetic warped panoramas at 128x256 in PIZ HALF (phase
    15's content, synthetic_crop), then cli.extract_distribution at its
    defaults (128 anchors, height 128) and batch EXTRACT_BATCH, twice (the
    first run builds the anchor index on the card). Checks: one pickle per
    panorama, each against representation.extract.extract_anchors on the CPU
    on the same file (rtol 1e-5). Times (the second run): panoramas/s over
    the CLI's loop, the host's native load_batch ms per batch (the loader
    thread) and the card's extraction ms per batch (CUDA events); and, on
    one batch on the card, extract_anchors_batch, its per-anchor sums as the
    port's index_add_ and as the one-hot matmul in full float32 the JAX
    package computes. Leaves the panoramas and the second run's pickles
    for phase 16c (out["files"])."""
    import pickle
    import shutil

    from emlight_tpu_torch import native
    from emlight_tpu_torch.cli import extract_distribution as cli_extract
    from emlight_tpu_torch.core.exr import write_exr
    from emlight_tpu_torch.core.hdr import read_hdr
    from emlight_tpu_torch.nn.layers import full_f32_matmul
    from emlight_tpu_torch.representation import extract as EX

    t_phase = time.perf_counter()
    work = os.path.join(HERE, "build", "extract_smoke")
    shutil.rmtree(work, ignore_errors=True)
    hdr_dir = os.path.join(work, "warped")
    os.makedirs(hdr_dir)
    rng = np.random.default_rng(seed + 80)
    t0 = time.perf_counter()
    names = [f"pano{i:02d}" for i in range(EXTRACT_PANOS)]
    for nm in names:
        write_exr(os.path.join(hdr_dir, f"{nm}.exr"), synthetic_crop(np, rng, 128, 256),
                  half=True, compression="piz")
    write_s = time.perf_counter() - t0
    runs = []
    for k in range(2):
        out_dir = os.path.join(work, f"pkl{k}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = cli_extract.main(["--hdr_dir", hdr_dir, "--out_dir", out_dir,
                               "--batch", str(EXTRACT_BATCH)])
        st["wall_s"] = time.perf_counter() - t0
        if st["panoramas"] != EXTRACT_PANOS or sorted(os.listdir(out_dir)) != [
                f"{nm}.pickle" for nm in names]:
            raise AssertionError(f"extract_distribution wrote {sorted(os.listdir(out_dir))[:4]}...")
        runs.append(st)
    st = runs[1]
    worst = 0.0
    for nm in names:
        ref = EX.extract_anchors(read_hdr(os.path.join(hdr_dir, f"{nm}.exr")), n=128,
                                 device="cpu")
        with open(os.path.join(work, "pkl1", f"{nm}.pickle"), "rb") as f:
            got = pickle.load(f)
        for k, v in got.items():
            r = ref[k].numpy()
            np.testing.assert_allclose(v, r, rtol=1e-5, atol=1e-7, err_msg=f"{nm} {k}")
            worst = max(worst, float(np.abs(v - r).max() / max(np.abs(r).max(), 1e-30)))
    imgs, _ = native.load_batch([os.path.join(hdr_dir, f"{nm}.exr")
                                 for nm in names[:EXTRACT_BATCH]], (128, 256))
    x = torch.from_numpy(imgs).to(dev)
    index, _ = EX._constants(128, 256, 128, str(x.device))
    onehot = torch.zeros(128 * 256, 128, device=dev)
    onehot[torch.arange(128 * 256, device=dev), index] = 1.0

    def matmul_sums():
        with full_f32_matmul():
            return (x.reshape(EXTRACT_BATCH, -1, 3).transpose(1, 2) @ onehot).transpose(1, 2)

    sums = EX._anchor_sums(x, index, 128)
    torch.testing.assert_close(sums, matmul_sums(), rtol=1e-5, atol=1e-3)
    times = {"extract_anchors_batch": cuda_ms(torch, lambda: EX.extract_anchors_batch(x, n=128)),
             "index_add": cuda_ms(torch, lambda: EX._anchor_sums(x, index, 128)),
             "matmul": cuda_ms(torch, matmul_sums)}
    out = {"write_dataset_s": write_s, "runs": runs, "pickle_worst_rel": worst,
           "panoramas_per_s": st["panoramas"] / st["seconds"],
           "load_ms_median": statistics.median(st["load_ms"]),
           "device_ms_median": statistics.median(st["device_ms"]), "batch_ms": times}
    log(f"[extract] {smi}: extract_distribution, {EXTRACT_PANOS} PIZ HALF panoramas of 128x256, "
        f"batch {EXTRACT_BATCH}, 128 anchors: {out['panoramas_per_s']:.3f} panoramas/s over the "
        f"loop ({st['seconds']:.3f} s; first run {runs[0]['panoramas'] / runs[0]['seconds']:.3f} "
        f"panoramas/s, {runs[0]['seconds']:.3f} s); host load_batch {out['load_ms_median']:.3f} "
        f"ms per batch (median; {[round(v, 3) for v in st['load_ms']]}), the card's extraction "
        f"{out['device_ms_median']:.3f} ms per batch (CUDA events, median; "
        f"{[round(v, 3) for v in st['device_ms']]})")
    log(f"[extract] {smi}: one batch of {EXTRACT_BATCH} on the card (median of 10): "
        f"extract_anchors_batch {times['extract_anchors_batch']:.4f} ms; its anchor sums as "
        f"index_add_ {times['index_add']:.4f} ms (the port's), as the one-hot matmul in full "
        f"float32 {times['matmul']:.4f} ms")
    log(f"[extract] checks: {EXTRACT_PANOS} pickles against extract_anchors on the CPU, worst "
        f"{worst:.3e} of the leaf's scale (rtol 1e-5); index_add_ sums equal the matmul's "
        f"(rtol 1e-5); dataset written in {write_s:.1f} s; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    # phase 16c reads these panoramas and pickles again, then removes them
    out["files"] = {"work": work, "warped": hdr_dir, "pickles": os.path.join(work, "pkl1"),
                    "names": names}
    return out


DIST_REG_BATCH, DIST_GAN_BATCH = 16, 8  # phase 16b (b)'s global batches, split over 2 ranks
DIST_TIMEOUT_S = 300  # phase 16b: each rank's collectives, and the parent's wait for them


def _dist_rank(index: int, work: str, n: int, backend: str, seed: int) -> None:
    """Phase 16b (b)/(c): one rank of `n`, spawned. Joins a `backend` group
    whose FileStore is in `work`; with gloo every rank shares card 0, with
    NCCL rank r takes card r. At full width: one regression train_step of
    the global batch DIST_REG_BATCH on each train_forward route, then a G,
    a D and a fused step with VGG of DIST_GAN_BATCH (Adam at lr 0, so
    every step starts from the seeded weights, as the parent's reference),
    each step's kernel launches read around it and held to the
    single-device step's; two more of each step timed. Saves the averaged
    gradients, the metrics, the launches and the times in work/rank{index}.pt."""
    sys.path.insert(0, HERE)
    os.environ.update(RANK=str(index), WORLD_SIZE=str(n), LOCAL_RANK=str(index))
    import numpy as np
    import torch

    from emlight_tpu_torch.dist import mesh
    from emlight_tpu_torch.dist.parallel import (make_parallel_fused_step,
                                                 make_parallel_projector_steps,
                                                 make_parallel_regression_step)
    from emlight_tpu_torch.nn import dense_conv_kernel as DK
    from emlight_tpu_torch.nn import sphere_conv_kernel as SK
    from emlight_tpu_torch.nn.vgg import VGG19Features, random_vgg19_params
    from emlight_tpu_torch.train import projector as PJ
    from emlight_tpu_torch.train import regression as RG

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", index if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    group, created = mesh.join(dev, "file://" + os.path.join(work, "store"),
                               timeout_s=DIST_TIMEOUT_S, backend=backend)
    wrappers = {**{k: getattr(DK, k) for k in EXPECTED_REG_STEP},
                **{k: getattr(SK, k) for k in EXPECTED_G_STEP}}
    out = {"launches": {}, "ms": {}, "grads": {}, "metrics": {}}
    timed = []

    def step(name, fn, expected, grads_of):
        """fn() once with the launches read around it; timed later."""
        torch.cuda.synchronize()
        for w_ in wrappers.values():
            w_.launches = 0
        metrics = fn()
        torch.cuda.synchronize()
        got = {k: wrappers[k].launches for k in expected}
        if got != expected:
            raise AssertionError(f"rank {index}: {name} launches {got}, expected {expected}")
        out["launches"][name] = got
        out["metrics"][name] = {k: v.item() for k, v in metrics.items()}
        out["grads"][name] = {f"{net}.{k}": p.grad.detach().cpu().clone()
                              for net, mod in grads_of for k, p in mod.named_parameters()}
        timed.append((name, fn))

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in mesh.shard_batch(batch,
                                                                               group).items()}

    states = {}
    for route in ("buffer", "standard"):
        cfg = dist_reg_cfg(route)
        states[route] = state = RG.create_state(cfg, device=dev, seed=seed + 130, group=group)
        run, batch = make_parallel_regression_step(group), on_card(dist_reg_batch(np, cfg, seed))
        step(f"regression {route}", lambda st=state, b=batch: run(st, b), EXPECTED_REG_STEP,
             [("regressor", state.model)])
    cfg = dist_gan_cfg()
    state = PJ.create_state(cfg, device=dev, seed=seed + 140, group=group)
    vgg = VGG19Features(random_vgg19_params(0), device=dev)
    batch = on_card(dist_gan_batch(np, cfg, seed))
    g_step, d_step = make_parallel_projector_steps(group, vgg)
    fused = make_parallel_fused_step(group, vgg)
    step("G step", lambda: g_step(state, batch)[0], EXPECTED_G_STEP, [("G", state.g)])
    step("D step", lambda: d_step(state, batch), EXPECTED_D_STEP, [("D", state.d)])
    step("fused step", lambda: fused(state, batch)[0], EXPECTED_FUSED_STEP,
         [("G", state.g), ("D", state.d)])
    # the times, once every step was recorded (a timed step moves u, v and
    # the running statistics); Adam at lr 0 keeps the weights
    for name, fn in timed:
        out["ms"][name] = cuda_ms(torch, fn, warmup=1, iters=3)
    mesh.barrier(group)
    mesh.leave(created)
    torch.save(out, os.path.join(work, f"rank{index}.pt"))


def dist_reg_cfg(route: str):
    """Phase 16b's regressor: RegressionConfig() on a train_forward route,
    Adam at lr 0."""
    from emlight_tpu_torch.config import RegressionConfig

    return dataclasses.replace(RegressionConfig(), train_forward=route, lr=0.0)


def dist_gan_cfg():
    """Phase 16b's GAN: ProjectorConfig() at batch DIST_GAN_BATCH, Adam at
    lr 0."""
    from emlight_tpu_torch.config import ProjectorConfig

    return dataclasses.replace(ProjectorConfig(), batch_size=DIST_GAN_BATCH, lr=0.0)


def dist_reg_batch(np, cfg, seed: int, jitter: bool = False) -> dict:
    """Phase 16b's regression batch (global), its crop jittered by JITTER
    relative if asked."""
    from emlight_tpu_torch.train.data import synthetic_regression_batch

    b = synthetic_regression_batch(DIST_REG_BATCH, cfg.anchors.regression_anchors,
                                   (cfg.crop_h, cfg.crop_w), seed=seed + 131)
    if jitter:
        rng = np.random.default_rng(seed + 132)
        b["crop"] = (b["crop"] * (1 + JITTER * rng.standard_normal(b["crop"].shape))
                     ).astype(np.float32)
    return b


def dist_gan_batch(np, cfg, seed: int, jitter: bool = False) -> dict:
    """Phase 16b's GAN batch (global), crop and target jittered by JITTER
    relative if asked."""
    from emlight_tpu_torch.train.data import synthetic_projector_batch

    b = synthetic_projector_batch(DIST_GAN_BATCH, n_anchors=cfg.anchors.n_anchors,
                                  crop_size=cfg.crop_size // 2,
                                  env_hw=(cfg.crop_size // 2, cfg.crop_size), seed=seed + 141)
    if jitter:
        rng = np.random.default_rng(seed + 142)
        b = {k: (v * (1 + JITTER * rng.standard_normal(v.shape))).astype(np.float32)
             if k in ("crop", "warped") else v for k, v in b.items()}
    return b


def spawn_ranks(torch, work: str, n: int, backend: str, seed: int) -> list:
    """Start `n` ranks of _dist_rank, join them with a deadline (killing
    them all when it passes), raise unless each exited 0; their results."""
    ctx = torch.multiprocessing.start_processes(_dist_rank, args=(work, n, backend, seed),
                                                nprocs=n, join=False, start_method="spawn")
    end = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, end - time.monotonic())):
            if time.monotonic() > end:
                raise AssertionError(f"{n} ranks ({backend}) passed their {DIST_TIMEOUT_S} s "
                                     "deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(n)]


def dist_references(torch, np, dev, seed: int) -> dict:
    """Phase 16b's single-device steps on the global batches, from the
    ranks' seeded states (Adam at lr 0), and again on the jittered batches:
    {(run, step): (metrics, grads)} with run "single" or "jittered"."""
    from emlight_tpu_torch.nn.vgg import VGG19Features, random_vgg19_params
    from emlight_tpu_torch.train import projector as PJ
    from emlight_tpu_torch.train import regression as RG

    out = {}
    for run, jitter in (("single", False), ("jittered", True)):
        for route in ("buffer", "standard"):
            cfg = dist_reg_cfg(route)
            state = RG.create_state(cfg, device=dev, seed=seed + 130)
            m = RG.train_step(state, dist_reg_batch(np, cfg, seed, jitter))
            out[run, f"regression {route}"] = (
                {k: v.item() for k, v in m.items()},
                {f"regressor.{k}": p.grad.cpu() for k, p in state.model.named_parameters()})
            del state
        cfg = dist_gan_cfg()
        state = PJ.create_state(cfg, device=dev, seed=seed + 140)
        vgg = VGG19Features(random_vgg19_params(0), device=dev)
        batch = dist_gan_batch(np, cfg, seed, jitter)
        grads = lambda *nets: {f"{name}.{k}": p.grad.cpu() for name, mod in nets  # noqa: E731
                               for k, p in mod.named_parameters()}
        m, _ = PJ.generator_step(state, batch, vgg)
        out[run, "G step"] = ({k: v.item() for k, v in m.items()}, grads(("G", state.g)))
        m = PJ.discriminator_step(state, batch)
        out[run, "D step"] = ({k: v.item() for k, v in m.items()}, grads(("D", state.d)))
        m, _ = PJ.fused_gan_step(state, batch, vgg)
        out[run, "fused step"] = ({k: v.item() for k, v in m.items()},
                                  grads(("G", state.g), ("D", state.d)))
        del state, vgg
    torch.cuda.empty_cache()
    return out


def hold_ranks_to_single(torch, ranks: list, ref: dict, where: str) -> list:
    """Every rank's averaged gradients equal on all ranks bit for bit; the
    metrics within 1e-4 relative of the single-device step's and every
    gradient leaf within the larger of GRAD_REL and GRAD_SPREAD times the
    single device's own spread under JITTER (phase 9's bar). Returns one
    summary per step."""
    summary = []
    for name in ranks[0]["grads"]:
        for r in ranks[1:]:
            for k, g in ranks[0]["grads"][name].items():
                if not torch.equal(g, r["grads"][name][k]):
                    raise AssertionError(f"{where} {name}: ranks hold different gradients at {k}")
        metrics, grads = ref["single", name]
        err = max(abs(v - metrics[k]) / max(abs(metrics[k]), 1e-6)
                  for k, v in ranks[0]["metrics"][name].items())
        if err > 1e-4:
            raise AssertionError(f"{where} {name}: metrics {ranks[0]['metrics'][name]} against "
                                 f"one device's {metrics}")
        spread = grad_ratios(ref["jittered", name][1], grads)
        got = grad_ratios(ranks[0]["grads"][name], grads)
        bar = max(GRAD_REL, GRAD_SPREAD * spread[-1][0])
        bad = [g for g in got if g[0] > bar]
        if bad:
            raise AssertionError(f"{where} {name}: {len(bad)} of {len(got)} gradient leaves above "
                                 f"{bar:.3e} of their scale; worst {bad[-3:]}")
        summary.append(f"{name}: metrics within {err:.2e}, worst leaf {got[-1][0]:.3e} "
                       f"({got[-1][1]}), spread {spread[-1][0]:.3e}, bar {bar:.3e}, launches "
                       f"{ranks[0]['launches'][name]} on each rank, "
                       + "/".join(f"{r['ms'][name]:.3f}" for r in ranks) + " ms by rank")
    return summary


def _file_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def run_dist(torch, np, dev, seed: int, smi, cli_files: dict, tcli_files: dict) -> dict:
    """Phase 16b: data-parallel training and serving (dist/, --parallel).

    (a) --parallel at world size 1 on NCCL, each run against the same run
    without it, under cuDNN's deterministic algorithms: train_regression
    (2 epochs of the phase 15 root at batch 16), train_projector --fused
    --vgg_random (1 epoch at batch 8), infer (phase 14's 17 crops at batch
    8) and test_projector (phase 15's root and checkpoint); checkpoints,
    maps and pickles equal byte for byte, metrics.csv equal but for its
    timing columns. (b) two ranks on this card over gloo with CUDA tensors,
    spawned (_dist_rank): the regression step at global batch 16 on both
    routes and the G, D and fused steps with VGG at global batch 8, against
    one device on the global batch at phase 9's bar, the launches of every
    step asserted on each rank; step times logged, which are no scaling
    figures (gloo stages each all-reduce through the host, and the ranks
    share the card). (c) the same over NCCL, one rank per card, where
    there are two cards or more. Removes phases 14 and 15's files."""
    import csv
    import shutil
    import tempfile

    from emlight_tpu_torch.cli import infer as cli_infer
    from emlight_tpu_torch.cli import test_projector as cli_test_projector
    from emlight_tpu_torch.cli import train_projector as cli_train_projector
    from emlight_tpu_torch.cli import train_regression as cli_train_regression

    t_phase = time.perf_counter()
    work = os.path.join(HERE, "build", "dist_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out: dict = {}

    # (a) --parallel at world size 1 on NCCL against the serial run, bit for bit
    torch.backends.cudnn.deterministic = True
    timing = {"time_per_iter", "time_per_item", "iter_p50_s", "iter_p90_s"}
    runs = {
        "train_regression": (cli_train_regression.main, [
            "--data_root", tcli_files["reg_root"], "--epochs", "2", "--batch_size", "16"],
            ["checkpoints/latest.msgpack", "iter.json"]),
        "train_projector --fused": (cli_train_projector.main, [
            "--data_root", tcli_files["proj_root"], "--epochs", "1", "--batch_size",
            str(TCLI_PROJ_BATCH), "--fused", "--vgg_random"],
            ["checkpoints/latest.msgpack", "iter.json"]),
        "infer": (cli_infer.main, [
            "--reg_ckpt", cli_files["reg_ckpt"], "--proj_ckpt", cli_files["proj_ckpt"],
            "--reg_config", cli_files["reg_run"], "--proj_config", cli_files["proj_run"],
            "--crops", cli_files["crop_dir"], "--batch", str(BATCH), "--save_pickles"], None),
        "test_projector": (cli_test_projector.main, [
            "--ckpt", tcli_files["proj_ckpt"], "--data_root", tcli_files["proj_root"],
            "--load_config", tcli_files["proj_run"]], None),
    }
    ws1 = []
    for name, (main_fn, argv, files) in runs.items():
        dirs = {who: os.path.join(work, name.replace(" --", "_") + "_" + who)
                for who in ("serial", "parallel")}
        t0 = time.perf_counter()
        for who, extra in (("serial", []), ("parallel", ["--parallel"])):
            main_fn(argv + ["--out_dir", dirs[who]] + extra)
            torch.cuda.synchronize()
        if files is None:  # serving: every file the serial run wrote
            files = sorted(os.listdir(dirs["serial"]))
            if sorted(os.listdir(dirs["parallel"])) != files:
                raise AssertionError(f"{name} --parallel wrote other files than the serial run")
        else:
            rows = []
            for who in ("serial", "parallel"):
                with open(os.path.join(dirs[who], "metrics.csv")) as f:
                    rows.append([{k: v for k, v in r.items() if k not in timing}
                                 for r in csv.DictReader(f)])
            if rows[0] != rows[1] or not rows[0]:
                raise AssertionError(f"{name} --parallel: metrics.csv differs from the serial "
                                     f"run's: {rows[0][:1]} against {rows[1][:1]}")
        for f in files:
            a, b = (_file_digest(os.path.join(dirs[who], f)) for who in ("serial", "parallel"))
            if a != b:
                raise AssertionError(f"{name} --parallel: {f} differs from the serial run's")
        ws1.append(f"{name}: {len(files)} files equal byte for byte "
                   f"({time.perf_counter() - t0:.1f} s for both runs)")
    torch.backends.cudnn.deterministic = False
    for files in (cli_files, tcli_files):
        shutil.rmtree(files["work"], ignore_errors=True)
    log(f"[dist] (a) {smi}: --parallel at world size 1 (NCCL) against the serial runs, "
        f"cuDNN deterministic: " + "; ".join(ws1))

    # (b) two ranks sharing this card over gloo, CUDA tensors
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gloo = tempfile.mkdtemp(dir=work)
    ranks = spawn_ranks(torch, gloo, 2, "gloo", seed)
    ranks_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = True
    ref = dist_references(torch, np, dev, seed)
    torch.backends.cudnn.deterministic = False
    summary = hold_ranks_to_single(torch, ranks, ref, "2 ranks, gloo")
    out["gloo_ms"] = {name: [r["ms"][name] for r in ranks] for name in ranks[0]["ms"]}
    log(f"[dist] (b) {smi}: 2 ranks on one card over gloo (CUDA tensors), regression at global "
        f"batch {DIST_REG_BATCH} and G/D/fused with VGG at {DIST_GAN_BATCH}, against one device "
        f"on the global batch (phase 9's bar; Adam at lr 0): " + "; ".join(summary)
        + f"; ranks took {ranks_s:.1f} s. The step times are no scaling figures: gloo stages "
        "every all-reduce through the host and the two ranks share one card")

    # (c) NCCL across cards
    if torch.cuda.device_count() >= 2:
        nccl = tempfile.mkdtemp(dir=work)
        ranks = spawn_ranks(torch, nccl, 2, "nccl", seed)
        summary = hold_ranks_to_single(torch, ranks, ref, "2 ranks, NCCL")
        out["nccl_ms"] = {name: [r["ms"][name] for r in ranks] for name in ranks[0]["ms"]}
        log("[dist] (c) 2 ranks on 2 cards over NCCL: " + "; ".join(summary))
    else:
        log(f"[dist] (c) skipped: {torch.cuda.device_count()} card (NCCL across cards needs 2)")
    shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dist] phase took {out['phase_s']:.1f} s")
    return out


# phase 16c: the SphereCNN demo's square maps at its default batch; the
# kernels a demo training step launches (conv1 60x60 1 -> 32 and conv2 30x30
# 32 -> 64 forward, both dK, conv2's dx on B6: conv1's input needs none)
DEMO_BATCH, DEMO_HW, DEMO_TRAIN, DEMO_TIMED = 32, (60, 60), 200, 10
EXPECTED_DEMO_STEP = {"sphere_conv_s1": 2, "sphere_conv_s2": 0, "sphere_conv_dx_s1": 0,
                      "sphere_conv_dx_s1_triple": 1, "sphere_conv_dk": 2,
                      "sphere_conv_dx_s2": 0}
# (B, H, W, Cin, Cout) of the demo's two convs; B6 runs conv2's dx
DEMO_CONVS = [(DEMO_BATCH, 60, 60, 1, 32), (DEMO_BATCH, 30, 30, 32, 64)]
NEEDLET_PANOS, FIT_STEPS, FIT_CHECKED = 16, 500, 10
DEMO_ACC_BAR = 0.3  # sphere_demo --train's last accuracy: well above 0.1, chance
# verify_parity's launches at full size: the generator's forward; each of
# the discriminator's two scales runs 3 stride-2 and 2 stride-1 convs
EXPECTED_PARITY = {"generator": {"sphere_conv_s1": LAUNCHES_PER_FORWARD},
                   "discriminator": {"sphere_conv_s1": 4, "sphere_conv_s2": 6},
                   "regression": {}}


def sparse_mismatch_ok(np, got, ref, dense, pipe, rtol: float = 1e-5) -> int:
    """Two sparsified needlet coefficient arrays (C, 3) against each other at
    rtol of ref's largest coefficient, where a coefficient may be kept on one
    side and zeroed on the other only if its band energy lies within rtol
    (relative) of the band's threshold, computed from `dense` (the same
    panorama's unsparsified coefficients). Returns the count of such
    threshold flips; raises on any other difference."""
    bad = np.abs(got - ref) > rtol * np.abs(ref).max()
    flips = 0
    for sl, pct in zip(pipe.slices, pipe.cfg.sparsity_percentiles):
        energy = np.abs(dense[sl]).sum(-1)
        thre = np.percentile(energy, pct)
        rows = np.nonzero(bad[sl].any(-1))[0]
        near = np.abs(energy[rows] - thre) <= rtol * max(thre, 1e-30)
        if not near.all():
            raise AssertionError(f"needlet coefficients differ away from the band's threshold "
                                 f"at {sl.start + rows[~near]}")
        flips += len(rows)
    return flips


def run_surface(torch, np, dev, seed: int, smi, extract_files: dict) -> dict:
    """Phase 16c: the rest of the single-card surface.

    (a) the SphereCNN demo at 60x60, batch 32, synthetic digits: B1, B4
    and B6 against their plain versions at the demo's shapes (f32 with TF32
    off, and bf16) and timed beside their bounds (f32); DEMO_TIMED training
    steps with every kernel's launches read around each (EXPECTED_DEMO_STEP)
    and timed (CUDA events), one more under the profiler; then
    cli.sphere_demo --train 200 (launches read around the run, accuracy
    above 0.3). (b) cli.verify_parity at full size on random-weight
    reference .pth files: DenseNet-BC (16,16,16) with 96 anchors, the
    generator at ngf 64 / crop 256, the discriminator at ndf 64, num_d 2,
    n_layers 4; each within 1e-3; B1's launches around the generator (44),
    B1's and B2's around the discriminator. (c) cli.needlets_gt on
    NEEDLET_PANOS of phase 16's panoramas at jmax 2 (sparsified) and 3
    (dense), twice on the card (cold, then warm) and once on the CPU, the
    card's .npy files against the CPU's; basis seconds, project ms,
    panoramas/s. (d) fit_spherical_gaussians, 3 lights, 500
    steps at 128x256 under torch.cuda's sync debug mode "error"; the loss
    falls, the first FIT_CHECKED losses within 1e-4 of the CPU's. (e)
    image_sinkhorn card vs CPU; cli.preview and cli.modify_pickles on phase
    16's files. Removes phase 16's files."""
    import contextlib
    import io
    import pickle
    import re
    import shutil

    from emlight_tpu_torch.cli import modify_pickles as cli_modify
    from emlight_tpu_torch.cli import needlets_gt as cli_needlets
    from emlight_tpu_torch.cli import preview as cli_preview
    from emlight_tpu_torch.cli import sphere_demo as cli_demo
    from emlight_tpu_torch.cli import verify_parity as cli_parity
    from emlight_tpu_torch.config import NeedletsConfig
    from emlight_tpu_torch.core.geometry import sphere_points
    from emlight_tpu_torch.core.hdr import TONEMAP_VIZ, read_hdr
    from emlight_tpu_torch.losses.image_ot import image_sinkhorn
    from emlight_tpu_torch.needlets import NeedletPipeline
    from emlight_tpu_torch.nn import sphere_conv_kernel as SK
    from emlight_tpu_torch.nn.sphere_conv import sphere_conv_plain
    from emlight_tpu_torch.nn.sphere_conv_vjp import dk_plain, dx_plain, inverse_tables
    from emlight_tpu_torch.nn.sphere_demo import OmniDigits, synthetic_digits
    from emlight_tpu_torch.representation import fit as FIT
    from emlight_tpu_torch.representation.splat import render_sg
    from emlight_tpu_torch.train import torch_ref as TR

    t_phase = time.perf_counter()
    names = list(EXPECTED_DEMO_STEP)
    wrappers = {n: getattr(SK, n) for n in names}
    work = os.path.join(HERE, "build", "surface_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out: dict = {}

    def counted(fn):
        """fn() with every kernel's count set to 0 just before, read after."""
        torch.cuda.synchronize()
        for w_ in wrappers.values():
            w_.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {n: w_.launches for n, w_ in wrappers.items()}

    def quiet(main, argv):
        """A CLI's main with its stdout captured: (return value, lines)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue().splitlines()

    # (a) the SphereCNN demo: its kernels at its shapes, then its steps
    gen = torch.Generator(device=dev).manual_seed(seed + 140)
    worst: dict = {}
    demo_rows: list = []

    def hold(name, kern, plain, dt, dk=False):
        out_, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out_ - ref).abs().max().item()
        if dt == torch.float32:
            rtol, atol = (1e-3, 1e-4) if dk else (1e-4, 1e-4)
            torch.testing.assert_close(out_, ref, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name} at the demo's shapes: {m}")
            key = (name, "float32")
            worst[key] = max(worst.get(key, 0.0), err)
        else:
            scale = ref.abs().max().item()
            if err > 2e-2 * scale:
                raise AssertionError(f"{name} bf16 at the demo's shapes: {err} > 2e-2 * {scale}")
            key = (name, "bf16_rel")
            worst[key] = max(worst.get(key, 0.0), err / scale)

    for (b, h, w, cin, cout) in DEMO_CONVS:
        x = torch.rand(b, h, w, cin, device=dev, generator=gen)
        k = torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5
        bias = torch.randn(cout, device=dev, generator=gen) * 0.1
        g = torch.randn(b, h, w, cout, device=dev, generator=gen) / (b * h * w) ** 0.5
        for dt in (torch.float32, torch.bfloat16):
            xd, kd, gd = x.to(dt), k.to(dt), g.to(dt)
            hold("sphere_conv_s1", lambda: SK.sphere_conv_s1(xd, kd, bias),
                 lambda: sphere_conv_plain(xd, kd, bias), dt)
            hold("sphere_conv_dk", lambda: SK.sphere_conv_dk(xd, gd, 1),
                 lambda: dk_plain(xd, gd, 1), dt, dk=True)
            if cin > 1:  # conv2: its dx runs B6 (30x30 < UMAJOR_MIN_PIXELS)
                gx = torch.randn(b, h, w, cout, device=dev, generator=gen).to(dt)
                hold("sphere_conv_dx_s1_triple",
                     lambda: SK.sphere_conv_dx_s1_triple(gx, kd, tuple(x.shape)),
                     lambda: dx_plain(gx, kd, tuple(x.shape), 1), dt)
        # f32 times at the demo's shapes: kernel, plain version, both bounds
        calls = [("sphere_conv_s1", "fwd", lambda: SK.sphere_conv_s1(x, k, bias),
                  lambda: sphere_conv_plain(x, k, bias)),
                 ("sphere_conv_dk", "dk", lambda: SK.sphere_conv_dk(x, g, 1),
                  lambda: dk_plain(x, g, 1))]
        if cin > 1:
            calls.append(("sphere_conv_dx_s1_triple", "dx",
                          lambda: SK.sphere_conv_dx_s1_triple(gx.float(), k, tuple(x.shape)),
                          lambda: dx_plain(gx.float(), k, tuple(x.shape), 1)))
        for name, kind, kern, plain in calls:
            fan = inverse_tables(h, w, 1)[-1] if kind == "dx" else 64
            bound, by = kernel_bound_ms(kind, b, h, w, cin, cout, 1, "float32", fan)
            tcb, _ = kernel_bound_ms(kind, b, h, w, cin, cout, 1, "float32", fan, tc=True)
            demo_rows.append({"kernel": name, "shape": [b, h, w, cin, cout], "ms": cuda_ms(
                torch, kern), "plain_ms": cuda_ms(torch, plain), "bound_ms": bound,
                "bound_by": by, "tc_bound_ms": tcb})
    fanin = inverse_tables(30, 30, 1)[-1]
    log(f"[surface] demo kernels at {DEMO_CONVS} (B, H, W, Cin, Cout; B6 at the second, "
        f"fan-in {fanin}): worst " + ", ".join(f"{n} {d} {v:.3e}" for (n, d), v in
                                               sorted(worst.items()))
        + " (f32 rtol=atol 1e-4, dK rtol 1e-3; bf16 2e-2 of max|ref|)")
    for r in demo_rows:
        log(f"[surface] {smi}: {r['kernel']} {r['shape']} f32: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), tc bound "
            f"{r['tc_bound_ms']:.4f} ms (CUDA events, median of 10)")

    images, labels = synthetic_digits(2048)
    ds = OmniDigits(images, labels, outshape=DEMO_HW, device=dev)
    model = cli_demo.SphereNet(DEMO_HW, seed=seed).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    step_ms, data_ms = [], []
    for i in range(DEMO_TIMED + 2):
        t0 = time.perf_counter()
        xb, yb = ds.batch(rng.integers(0, len(ds), DEMO_BATCH))
        xt = torch.from_numpy(xb / 255.0).to(dev)
        yt = torch.from_numpy(yb).long().to(dev)
        torch.cuda.synchronize()
        data_ms.append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        (loss, acc), got = counted(lambda: cli_demo.train_step(model, opt, xt, yt))
        ev[1].record()
        if got != EXPECTED_DEMO_STEP:
            raise AssertionError(f"demo step {i}: launches {got}, expected {EXPECTED_DEMO_STEP}")
        if not torch.isfinite(loss):
            raise AssertionError(f"demo step {i}: loss {loss.item()}")
        step_ms.append(ev[0].elapsed_time(ev[1]))
    step_ms, data_ms = step_ms[2:], data_ms[2:]  # the first two build tables and Adam state
    prof = device_profile(torch, lambda: cli_demo.train_step(model, opt, xt, yt))
    if prof is None:
        log("[surface] the profiler saw no device work in a SphereNet step: not measured")
    else:
        wall_ms, busy_ms, ranked = prof
        log(f"[surface] one SphereNet step under the profiler: {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top device work:")
        for name, ms, n in ranked:
            log(f"[surface]   {ms:9.3f} ms  {ms / busy_ms:.4f}  x{n:<4d} {name[:100]}")
    for w_ in wrappers.values():
        w_.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, lines = quiet(cli_demo.main, ["--train", str(DEMO_TRAIN), "--batch", str(DEMO_BATCH)])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    demo_launches = {n: w_.launches for n, w_ in wrappers.items()}
    want = {n: v * DEMO_TRAIN for n, v in EXPECTED_DEMO_STEP.items()}
    if demo_launches != want:
        raise AssertionError(f"sphere_demo --train {DEMO_TRAIN}: launches {demo_launches}, "
                             f"expected {want}")
    if not acc > DEMO_ACC_BAR:
        raise AssertionError(f"sphere_demo --train {DEMO_TRAIN}: accuracy {acc} (bar "
                             f"{DEMO_ACC_BAR}); "
                             f"{lines[-3:]}")
    out["demo"] = {"kernel_worst": {f"{n} {d}": v for (n, d), v in worst.items()},
                   "kernel_rows": demo_rows, "profile": prof,
                   "step_ms": statistics.median(step_ms), "data_ms": statistics.median(data_ms),
                   "train_s": demo_s, "train_acc": acc, "launches": demo_launches}
    log(f"[surface] {smi}: SphereNet step at batch {DEMO_BATCH}, {DEMO_HW[0]}x{DEMO_HW[1]}: "
        f"{out['demo']['step_ms']:.4f} ms (CUDA events, median of {DEMO_TIMED}; "
        f"{[round(v, 4) for v in step_ms]}), its batch's projection and copy "
        f"{out['demo']['data_ms']:.4f} ms on the host clock; launches per step "
        f"{EXPECTED_DEMO_STEP} (asserted); sphere_demo --train {DEMO_TRAIN}: "
        f"{demo_s:.3f} s, last accuracy {acc:.4f} (bar 0.3), launches {demo_launches}; "
        + "; ".join(lines[-2:]))

    # (b) verify_parity at full size
    parity = {}
    parity_launches = dict.fromkeys(names, 0)
    t0 = time.perf_counter()
    dn = TR.build_torch_densenet(block_config=(16, 16, 16), n_anchors=96, pooled_hw=(6, 8))
    TR.randomize_densenet(dn, seed=seed)
    tg = TR.TGenerator(ngf=64, crop_size=256)
    TR.randomize(tg, seed=seed)
    td = TR.TMultiscaleD(ndf=64, num_d=2, n_layers=4, input_nc=6)
    TR.randomize(td, seed=seed + 1)
    for stage, m in (("regression", dn), ("generator", tg), ("discriminator", td)):
        torch.save(m.state_dict(), os.path.join(work, f"{stage}.pth"))
    del dn, tg, td
    write_s = time.perf_counter() - t0
    for stage in ("regression", "generator", "discriminator"):
        t0 = time.perf_counter()
        (rc, lines), got = counted(lambda: quiet(
            cli_parity.main, ["--torch_pth", os.path.join(work, f"{stage}.pth")]))
        secs = time.perf_counter() - t0
        want = {n: EXPECTED_PARITY[stage].get(n, 0) for n in names}
        if got != want:
            raise AssertionError(f"verify_parity {stage}: launches {got}, expected {want}")
        for n in names:
            parity_launches[n] += got[n]
        if rc != 0:
            raise AssertionError(f"verify_parity {stage} failed: {lines}")
        worst_rel = float(re.search(r"worst (\S+) vs tol", lines[-1]).group(1))
        parity[stage] = {"worst_rel": worst_rel, "seconds": secs,
                         "launches": {n: v for n, v in got.items() if v}}
        log(f"[surface] verify_parity {stage} at full size: {lines[-1]} ({secs:.1f} s; "
            f"launches {parity[stage]['launches']})")
    out["parity"] = {**parity, "write_pth_s": write_s, "launches": parity_launches}

    # (c) needlets_gt on phase 16's panoramas
    sub = os.path.join(work, "warped")
    os.makedirs(sub)
    for nm in extract_files["names"][:NEEDLET_PANOS]:
        shutil.copy(os.path.join(extract_files["warped"], f"{nm}.exr"), sub)
    needlets = {}
    for jmax in (2, 3):
        runs = {}
        for where in ("first", "cuda", "cpu"):  # "first": the card's cold run
            (st, lines), _ = counted(lambda: quiet(cli_needlets.main, [
                "--hdr_dir", sub, "--out_dir", os.path.join(work, f"nl{jmax}_{where}"),
                "--jmax", str(jmax), "--batch", str(NEEDLET_PANOS),
                "--device", "cuda" if where == "first" else where]))
            runs[where] = st
        pipe = NeedletPipeline(NeedletsConfig(jmax=jmax), device="cpu")
        worst_rel, flips = 0.0, 0
        for nm in extract_files["names"][:NEEDLET_PANOS]:
            a = np.load(os.path.join(work, f"nl{jmax}_cuda", f"{nm}.npy"))
            r = np.load(os.path.join(work, f"nl{jmax}_cpu", f"{nm}.npy"))
            if a.shape != (pipe.n_coeffs, 3):
                raise AssertionError(f"needlets_gt --jmax {jmax}: {nm}.npy {a.shape}")
            worst_rel = max(worst_rel, float(np.abs(a - r).max() / np.abs(r).max()))
            if jmax == 2:
                dense = pipe.project(torch.from_numpy(
                    read_hdr(os.path.join(sub, f"{nm}.exr"))[None]))[0].numpy()
                flips += sparse_mismatch_ok(np, a, r, dense, pipe)
            elif not np.allclose(a, r, rtol=0, atol=1e-5 * np.abs(r).max()):
                raise AssertionError(f"needlets_gt --jmax 3: {nm} card vs CPU beyond 1e-5")
        st, cold = runs["cuda"], runs["first"]
        needlets[jmax] = {"coeffs": pipe.n_coeffs, "basis_s": cold["basis_s"],
                          "panoramas_per_s": st["panoramas"] / st["seconds"],
                          "project_ms": st["device_ms"], "first_project_ms": cold["device_ms"],
                          "first_panoramas_per_s": cold["panoramas"] / cold["seconds"],
                          "worst_rel": worst_rel, "threshold_flips": flips,
                          "cpu_s": runs["cpu"]["seconds"]}
        log(f"[surface] {smi}: needlets_gt --jmax {jmax} ({pipe.n_coeffs} coefficients, "
            f"{'sparsified' if jmax == 2 else 'dense'}), {NEEDLET_PANOS} PIZ HALF panoramas "
            f"of 128x256 in one batch: basis built in {cold['basis_s']:.3f} s (host, NumPy), "
            f"project{' + sparsify' if jmax == 2 else ''} {st['device_ms'][0]:.4f} ms on the "
            f"card (CUDA events; the cold first run {cold['device_ms'][0]:.4f} ms), "
            f"{needlets[jmax]['panoramas_per_s']:.3f} panoramas/s over the CLI's loop "
            f"({st['seconds']:.3f} s; first run {cold['seconds']:.3f} s, CPU run "
            f"{runs['cpu']['seconds']:.3f} s); "
            f".npy card vs CPU worst {worst_rel:.3e} of the file's largest coefficient "
            f"(bar 1e-5), threshold flips {flips}")
    out["needlets"] = needlets

    # (d) fit_spherical_gaussians with no host sync inside its loop
    dirs = torch.tensor(sphere_points(16)[[2, 7, 12]], dtype=torch.float32)
    pano = render_sg(dirs[None], torch.full((1, 3), 0.05),
                     torch.tensor([[[8.0, 6.0, 4.0], [3.0, 3.0, 3.0], [1.0, 2.0, 4.0]]]),
                     h=128, w=256)[0] + 0.2
    pano_d = pano.to(dev)
    init = {k: torch.from_numpy(v).to(dev) for k, v in FIT.initial_params(3, seed).items()}
    FIT.fit_spherical_gaussians(pano_d, n_lights=3, steps=2, init=init)  # tables onto the card
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev[0].record()
        fitted, env, metrics = FIT.fit_spherical_gaussians(pano_d, n_lights=3, steps=FIT_STEPS,
                                                           init=init)
        ev[1].record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    fit_ms = ev[0].elapsed_time(ev[1])
    losses = metrics["loss"].cpu().numpy()
    _, _, cpu_m = FIT.fit_spherical_gaussians(pano, n_lights=3, steps=FIT_CHECKED,
                                              init=FIT.initial_params(3, seed), device="cpu")
    cpu_losses = cpu_m["loss"].numpy()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fit: losses {losses[0]} -> {losses[-1]}")
    np.testing.assert_allclose(losses[:FIT_CHECKED], cpu_losses, rtol=1e-4,
                               err_msg="fit: the first losses, card vs CPU")
    fit_rel = float(np.abs(losses[:FIT_CHECKED] - cpu_losses).max() / np.abs(cpu_losses).max())
    cos = (fitted["dirs"].cpu() @ dirs.T).max(0).values
    out["fit"] = {"ms_per_step": fit_ms / FIT_STEPS, "loss_first": float(losses[0]),
                  "loss_last": float(losses[-1]), "first_losses_rel": fit_rel,
                  "best_cos": cos.tolist()}
    log(f"[surface] {smi}: fit_spherical_gaussians, 3 lights, {FIT_STEPS} steps at 128x256 "
        f"under sync debug mode \"error\" (no host sync inside): {fit_ms / FIT_STEPS:.4f} ms "
        f"per step (CUDA events over the call); loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"first {FIT_CHECKED} losses within {fit_rel:.3e} of the CPU's (rtol 1e-4); best "
        f"cosine to each true light {[round(c, 4) for c in cos.tolist()]}")

    # (e) the small tools
    rng = np.random.default_rng(seed + 141)
    a_ = rng.random((2, 3, 32, 64)).astype(np.float32) + 1e-3
    b_ = rng.random((2, 3, 32, 64)).astype(np.float32) + 1e-3
    ot_card = image_sinkhorn(torch.from_numpy(a_).to(dev), torch.from_numpy(b_).to(dev),
                             reg=0.05, max_iter=20).cpu()
    ot_cpu = image_sinkhorn(torch.from_numpy(a_), torch.from_numpy(b_), reg=0.05, max_iter=20)
    ot_rel = float((ot_card - ot_cpu).abs().max() / ot_cpu.abs().max())
    torch.testing.assert_close(ot_card, ot_cpu, rtol=1e-4, atol=0,
                               msg=lambda m: f"image_sinkhorn card vs CPU: {m}")
    prev_dir = os.path.join(work, "preview")
    n_prev, _ = quiet(cli_preview.main, ["--hdr_dir", sub, "--out_dir", prev_dir])
    for nm in extract_files["names"][:NEEDLET_PANOS]:
        want_png = (TONEMAP_VIZ(read_hdr(os.path.join(sub, f"{nm}.exr")))[0] * 255).astype(
            np.uint8)
        if not np.array_equal(read_png(os.path.join(prev_dir, f"{nm}.png"), np), want_png):
            raise AssertionError(f"preview {nm}.png is not TONEMAP_VIZ x 255")
    pkl_src, scaled = extract_files["pickles"], os.path.join(work, "scaled")
    quiet(cli_modify.main, ["--pkl_dir", pkl_src, "--out_dir", scaled,
                            "--scale_intensity", "2.0", "--scale_ambient", "0.5"])
    for nm in os.listdir(pkl_src):
        with open(os.path.join(pkl_src, nm), "rb") as f:
            src = pickle.load(f)
        with open(os.path.join(scaled, nm), "rb") as f:
            got = pickle.load(f)
        if not (np.array_equal(got["intensity"], np.asarray(src["intensity"]) * 2.0)
                and np.array_equal(got["ambient"], np.asarray(src["ambient"]) * 0.5)
                and np.array_equal(got["distribution"], src["distribution"])):
            raise AssertionError(f"modify_pickles scaling: {nm}")
    legacy = {}
    for where in ("cuda", "cpu"):
        quiet(cli_modify.main, ["--hdr_dir", sub, "--out_dir", os.path.join(work, f"l42_{where}"),
                                "--legacy_42", "--device", where])
    legacy_rel = 0.0
    for nm in extract_files["names"][:NEEDLET_PANOS]:
        for where in ("cuda", "cpu"):
            with open(os.path.join(work, f"l42_{where}", f"{nm}.pickle"), "rb") as f:
                legacy[where] = pickle.load(f)
        if legacy["cuda"]["distribution"].shape != (42,):
            raise AssertionError(f"modify_pickles --legacy_42: {nm}")
        for k, v in legacy["cpu"].items():
            np.testing.assert_allclose(legacy["cuda"][k], v, rtol=1e-5,
                                       err_msg=f"--legacy_42 card vs CPU: {nm} {k}")
            legacy_rel = max(legacy_rel, float(np.abs(legacy["cuda"][k] - v).max()
                                               / np.abs(v).max()))
    out["tools"] = {"image_sinkhorn_rel": ot_rel, "previews": n_prev,
                    "legacy_42_worst_rel": legacy_rel}
    log(f"[surface] image_sinkhorn (2, 3, 32, 64), reg 0.05, 20 iterations: card vs CPU "
        f"{ot_rel:.3e} (rtol 1e-4); preview: {n_prev} PNGs equal TONEMAP_VIZ x 255; "
        f"modify_pickles: {len(os.listdir(pkl_src))} pickles scaled exactly, --legacy_42 card "
        f"vs CPU {legacy_rel:.3e} (rtol 1e-5); phase took {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(extract_files["work"], ignore_errors=True)
    out["launches"] = {"demo": demo_launches, "parity": parity_launches}
    return out


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
    from emlight_tpu_torch.nn import dense_conv_kernel as DK
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
    sphere_conv_s1.launches = DK.dense_conv_fwd.launches = 0
    unsat = []
    for i, (crop_reg, crop_proj) in enumerate(reqs):
        before, before_b7 = sphere_conv_s1.launches, DK.dense_conv_fwd.launches
        env, pred = request(crop_reg, crop_proj)
        torch.cuda.synchronize()
        grew = sphere_conv_s1.launches - before
        if grew != LAUNCHES_PER_FORWARD:
            raise AssertionError(f"request {i}: {grew} kernel launches, expected 44")
        # the regressor's buffer eval forward: B7 once per dense layer
        grew_b7 = DK.dense_conv_fwd.launches - before_b7
        if grew_b7 != EXPECTED_REG_STEP["dense_conv_fwd"]:
            raise AssertionError(f"request {i}: B7 launched {grew_b7} times, expected 48")
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
    serving_b7 = DK.dense_conv_fwd.launches
    if main_launches != LAUNCHES_PER_FORWARD * REQUESTS or main_launches == 0:
        raise AssertionError(f"main path launched the kernel {main_launches} times")
    log(f"[slice] {REQUESTS} requests x batch {BATCH}: env (B,128,256,3) finite, "
        f"in [0, 50], not constant; kernel launches {main_launches} "
        f"({LAUNCHES_PER_FORWARD} per request), B7 {serving_b7} (48 per request: the "
        f"regressor's buffer eval forward); unsaturated share "
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
            "dense_conv_yardstick_ms": cuda_ms(torch, dense_conv_yardstick(torch, x, cout)),
        }
        row["bound_ms"], row["bound_by"] = conv_bound_ms(b, h, w, cin, cout, "float32")
        row["tc_bound_ms"], _ = conv_bound_ms(b, h, w, cin, cout, "float32", tc=True)
        row["bf16_bound_ms"], _ = conv_bound_ms(b, h, w, cin, cout, "bfloat16", tc=True)
        rows.append(row)
        log(f"[timing] sphere_conv_s1 B{b} {h}x{w} {cin}->{cout} x{row['per_forward']}: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), tc bound "
            f"{row['tc_bound_ms']:.4f} ms, bf16 kernel {row['bf16_ms']:.4f} ms (tc bound "
            f"{row['bf16_bound_ms']:.4f}), cuDNN dense conv yardstick "
            f"{row['dense_conv_yardstick_ms']:.4f} ms")
    del x, k, xb, kb
    report_check(f"at batches 2 and {b}")
    total = {key: sum(r[key] * r["per_forward"] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "tc_bound_ms", "bf16_ms", "bf16_bound_ms",
                         "dense_conv_yardstick_ms")}
    ops_ms = sum(r["bound_ms"] * r["per_forward"] for r in rows if r["bound_by"] == "operations")
    total_bound_by = "operations" if ops_ms >= total["bound_ms"] / 2 else "bytes"

    crop_reg, crop_proj = crops(b)
    guide = PL.predicted_guide(RG.predict(regressor, crop_reg), 128, 256,
                               proj_cfg.anchors.splat_size)
    # the regressor's three eval forwards: the module's standard graph, the
    # buffer forward pipeline_inference runs (make_eval_apply) and the
    # closure over this checkpoint (make_baked_infer)
    eval_apply = RG.make_eval_apply(reg_cfg)
    baked = RG.make_baked_infer(reg_cfg, regressor)
    with torch.inference_mode():
        std_out, buf_out = regressor(crop_reg), eval_apply(regressor, crop_reg)
        baked_out = baked(crop_reg)
        reg_err = max((buf_out[k] - std_out[k]).abs().max().item() / std_out[k].abs().max().item()
                      for k in std_out)
        for k in std_out:
            torch.testing.assert_close(buf_out[k], std_out[k], rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f"buffer vs standard forward {k}: {m}")
            if not torch.equal(baked_out[k], buf_out[k]):
                raise AssertionError(f"make_baked_infer's {k} differs from make_eval_apply's")
        reg_ms = cuda_ms(torch, lambda: regressor(crop_reg))
        buf_ms = cuda_ms(torch, lambda: eval_apply(regressor, crop_reg))
        baked_ms = cuda_ms(torch, lambda: baked(crop_reg))
        gen_ms = cuda_ms(torch, lambda: generator(guide, crop_proj))
    pipe_ms = cuda_ms(torch, lambda: request(crop_reg, crop_proj))
    log(f"[timing] {smi}: batch {b}: regressor eval forwards (CUDA events, median of 10): "
        f"standard {reg_ms:.3f} ms, buffer (make_eval_apply, the pipeline's) {buf_ms:.3f} ms, "
        f"baked (make_baked_infer) {baked_ms:.3f} ms; heads buffer vs standard within "
        f"{reg_err:.3e} of their scale (rtol 1e-4, atol 1e-5), baked == buffer bit for bit")
    log(f"[timing] batch {b}: regressor {buf_ms:.3f} ms, generator {gen_ms:.3f} ms, "
        f"pipeline_inference {pipe_ms:.3f} ms; the generator's 44 sphere convs: kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms ({total_bound_by}), tc bound {total['tc_bound_ms']:.3f} ms, "
        f"bf16 kernel {total['bf16_ms']:.3f} ms (tc bound {total['bf16_bound_ms']:.3f}), cuDNN "
        f"dense conv yardstick {total['dense_conv_yardstick_ms']:.3f} ms")

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

    tables = {"serving_shapes": rows, "regressor_eval_ms": {
        "standard": reg_ms, "buffer": buf_ms, "baked": baked_ms}}

    def save():
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": smi, **tables}, f, indent=1)

    train = run_training(torch, np, dev, args.seed, tables, save)
    save()
    run_card_vs_cpu(torch, np, dev, args.seed)
    tables["gan"] = run_gan_objective(torch, np, dev, args.seed, tables, train, smi)
    del train["state"], train["batches"]
    save()
    reg_entries = run_regression(torch, np, dev, args.seed, tables, save)
    run_regression_card_vs_cpu(torch, np, dev, args.seed)
    tables["cli"] = run_cli(torch, np, dev, args.seed, regressor, generator, reg_cfg, proj_cfg,
                            smi)
    save()
    tables["tcli"] = run_train_cli(torch, np, dev, args.seed, tables, smi)
    save()
    tables["extract"] = run_extract(torch, np, dev, args.seed, smi)
    save()
    extract_files = tables["extract"].pop("files")
    tables["dist"] = run_dist(torch, np, dev, args.seed, smi, tables["cli"].pop("files"),
                              tables["tcli"].pop("files"))
    save()
    tables["surface"] = run_surface(torch, np, dev, args.seed, smi, extract_files)
    save()

    # 17. kernels line
    kernels_line = {"kernels": [{
        "name": "sphere_conv_s1",
        "id": "B1",
        "route": "cuda",
        "source": KERNELS["sphere_conv_s1"][1],
        "replaces": KERNELS["sphere_conv_s1"][2],
        "launches": main_launches,
        "cli_launches": tables["cli"]["b1_launches"],
        "train_launches": train["b1_train_launches"],
        "max_abs_err": worst["float32"],
        "max_err_f32": worst["float32"],
        "max_err_bf16": worst["bfloat16"],
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "tc_bound_ms": total["tc_bound_ms"],
        "bound_by": total_bound_by,
        "library_ms": None,
        "dense_conv_yardstick_ms": total["dense_conv_yardstick_ms"],
        "train_ms": train["b1_train"]["ms"],
        "train_tc_bound_ms": train["b1_train"]["tc_bound_ms"],
        "train_dense_conv_yardstick_ms": train["b1_train"]["dense_conv_yardstick_ms"],
    }] + train["entries"] + reg_entries}
    for entry in kernels_line["kernels"]:  # the training CLIs' launches, phase 15
        entry["tcli_launches"] = tables["tcli"]["launches"][entry["name"]]
        if entry["name"] in EXPECTED_FUSED_STEP:  # phase 9b's, and per fused step
            entry["gan_launches"] = tables["gan"]["launches"][entry["name"]]
            entry["fused_step_launches"] = EXPECTED_FUSED_STEP[entry["name"]]
        if entry["name"] == "dense_conv_fwd":  # the regressor's buffer eval forward, phase 4
            entry["serving_launches"] = serving_b7
        if entry["name"] in EXPECTED_DEMO_STEP:  # phase 16c: sphere_demo --train, verify_parity
            entry["demo_launches"] = tables["surface"]["launches"]["demo"][entry["name"]]
            entry["parity_launches"] = tables["surface"]["launches"]["parity"][entry["name"]]
    log(smi)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
