"""Concat-free DenseNet forwards: the eval and train forwards the JAX package
runs by default.

Port of emlight_tpu/nn/densenet_fast.py (``_bn_affine``, ``fast_apply``,
``buffer_apply``, ``train_apply``, ``_batch_stats_nchw``,
``_norm_train_nchw``, ``_ra_update``, ``_avg_pool_nchw`` and the dense
block's structured VJP ``_block_core``). They evaluate a
nn/densenet.py::DenseNet's own parameters with the same math as its
standard forward, up to float reassociation, but never rewrite the growing
channel concat: each dense block's features live in ONE preallocated
buffer, and every layer reads its leading ``cin`` channels and writes its
``growth_rate`` new ones in place.

Layout. The buffer is channels-last, (B, H, W, C_total), and so is every
tensor of these forwards (the JAX package chose an NCHW buffer for the
TPU's (8, 128) tiles). A layer's input is the view ``buf[..., :cin]``;
norm1 + ReLU write one contiguous (B·H·W, cin) operand for the 1×1 conv, a
single GEMM with the layer's (cin, 48) kernel, whose output h1 is the
contiguous NHWC tensor the dense-layer conv kernel reads. JAX's
``buffer_apply`` switch ``interior`` (an NHWC interior at batch ≥ 128, else
NCHW) picks between two TPU lowerings with bit-identical outputs; there is
nothing to pick here, so it is not ported.

The dense layer's norm2 -> conv2 runs as conv3x3(h1 * a + b, K) through the
wrappers of nn/dense_conv_kernel.py: B7 forward, B7' (dx, da, db) and B8
(dK) backward on the card, their plain versions on the CPU. Everything else
(the stem, the 1×1 convs, the transitions, the fc) is cuDNN/cuBLAS, as the
JAX package computes it outside Pallas.

- ``buffer_apply`` (eval): BatchNorm as a per-channel affine from the
  running statistics (``_bn_affine``). ``eval_plan`` computes those
  affines and lays out the kernels once; ``buffer_forward`` runs a plan,
  so a serving closure can keep one (train/regression.py::make_baked_infer).
- ``fast_apply`` (eval): the features as a list of pieces, every consumer
  of the concat a sum over pieces, ``group`` consecutive layer outputs
  compacted into one slab.
- ``train_apply`` (train): flax-exact train-mode BatchNorm. Planes are
  immutable once written, so each plane's batch moments (mean, mean of
  squares) are computed once, when it is written, and every norm1 reads
  the moments of its leading ``cin`` planes: O(C) reductions, where the
  standard forward re-reduces the whole concat at every layer, O(L·C). A
  dense block is one autograd Function (``_DenseBlock``): its forward fills
  the buffer under no_grad and saves the final buffer, each layer's h1 and
  the moments; its backward walks the layers in reverse, re-slices the
  final buffer (layer j's input is ``buf[..., :cin_j]`` bit for bit),
  recomputes only the elementwise staging, and routes each moment's
  cotangent onto its plane analytically: for m = mean(x), m2 = mean(x²)
  over N elements, dL/dx += g_m / N + 2·x·g_m2 / N. ``block_vjp=False``
  runs the same loop out of place under plain autograd: the tests' oracle
  (JAX's debug path), not a fallback.

The running statistics are updated in place, once per forward (flax's
momentum rule, the biased variance), as the standard train forward does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dense_conv import fused_affine_conv3x3
from .dense_conv_kernel import dense_conv_dk, dense_conv_dx, dense_conv_fwd
from ..dist.mesh import all_reduce_sum_, global_moments
from .densenet import DenseNet, heads_f32

__all__ = ["buffer_apply", "buffer_forward", "eval_plan", "fast_apply", "train_apply"]


def _stat_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def _bn_affine(bn, dt: torch.dtype, eps: float = 1e-5):
    """Eval-mode BatchNorm as per-channel (a, b), y = x * a + b, computed in
    float32 from the running statistics and cast to the compute dtype."""
    mean, var = bn.running_stats()
    a = bn.weight / torch.sqrt(var + eps)
    b = bn.bias - mean * a
    return a.to(dt), b.to(dt)


def _conv3x3_nhwc(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv (cuDNN) of an NHWC tensor with an OIHW weight cast to
    x's dtype; NHWC out."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def _matmul_c(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., C) @ (C, D) -> (..., D): a 1x1 conv of an NHWC tensor."""
    return (x.reshape(-1, x.shape[-1]) @ k).view(*x.shape[:-1], k.shape[1])


def _avg_pool_nhwc(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool, VALID (a partial window at the edge is dropped),
    as a reshape and sum, divided by k*k in x's dtype."""
    b, h, w, c = x.shape
    hk, wk = h // k * k, w // k * k
    x = x[:, :hk, :wk]
    return x.reshape(b, hk // k, k, wk // k, k, c).sum((2, 4)) / (k * k)


def _conv1x1_kernel(conv) -> torch.Tensor:
    """A 1x1 conv's OIHW weight as the (cin, cout) matrix of ``_matmul_c``
    (a view)."""
    return conv.weight[:, :, 0, 0].t()


def _conv3x3_kernel(conv) -> torch.Tensor:
    """A 3x3 conv's OIHW weight as HWIO (a view), the dense-layer kernels'
    layout."""
    return conv.weight.permute(2, 3, 1, 0)


# -- eval ----------------------------------------------------------------------


def _eval_conv2(h1: torch.Tensor, a2: torch.Tensor, b2: torch.Tensor,
                k2: torch.Tensor) -> torch.Tensor:
    """norm2 -> conv2 at eval: conv3x3(h1 * a2 + b2, K) by ``dense_conv_fwd``
    (B7 on the card), rounded to h1's dtype."""
    return dense_conv_fwd(h1, a2, b2, k2).to(h1.dtype)


@torch.no_grad()
def eval_plan(model: DenseNet) -> dict:
    """What the eval forwards read of the model, computed once: every
    BatchNorm's eval affine in the compute dtype (norm2's in float32, the
    dense-layer conv's operand type), the 1×1 kernels as (cin, cout)
    matrices and the 3×3 ones as HWIO, all in the compute dtype and
    contiguous."""
    dt = model.dtype
    plan = {"dtype": dt, "conv0": model.conv0.weight.to(dt).contiguous(),
            "norm0": _bn_affine(model.norm0, dt), "blocks": []}
    for i, num_layers in enumerate(model.block_config, start=1):
        layers = []
        for j in range(1, num_layers + 1):
            layer = model.dense_layer(i, j)
            layers.append((*_bn_affine(layer.norm1, dt),
                           _conv1x1_kernel(layer.conv1).to(dt).contiguous(),
                           *_bn_affine(layer.norm2, _stat_dtype(dt)),
                           _conv3x3_kernel(layer.conv2).to(dt).contiguous()))
        tr = getattr(model, f"transition{i}")
        plan["blocks"].append({
            "layers": layers,
            "transition": (*_bn_affine(tr.norm, dt), _conv1x1_kernel(tr.conv).to(dt).contiguous()),
            "last_norm": _bn_affine(getattr(model, f"last_norm{i}"), dt),
        })
    plan["fc"] = (model.fc.weight.to(dt).contiguous(), model.fc.bias.to(dt))
    return plan


def _finish(model: DenseNet, plan: dict, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """ReLU, the global average pool, the H, W, C flatten, the fc in the
    compute dtype and the four heads in float32."""
    x = _avg_pool_nhwc(F.relu(x), model.avgpool_size).flatten(1)
    return heads_f32(model, F.linear(x, *plan["fc"]))


@torch.no_grad()
def buffer_forward(model: DenseNet, plan: dict, crop: torch.Tensor) -> dict[str, torch.Tensor]:
    """The channels-last buffer eval forward on a plan of ``eval_plan``:
    crop (B, H, W, 3) -> the four heads."""
    g = model.growth_rate
    x = _conv3x3_nhwc(crop.to(plan["dtype"]), plan["conv0"])
    a, b = plan["norm0"]
    x = torch.addcmul(b, x, a).relu_()
    for blk in plan["blocks"]:
        bsz, hh, ww, c0 = x.shape
        total = c0 + len(blk["layers"]) * g
        buf = x.new_empty(bsz, hh, ww, total)
        buf[..., :c0] = x
        for j, (a1, b1, k1, a2, b2, k2) in enumerate(blk["layers"]):
            cin = c0 + j * g
            # no ReLU between norm2 and conv2 (reference layer order)
            h1 = _matmul_c(torch.addcmul(b1, buf[..., :cin], a1).relu_(), k1)
            buf[..., cin:cin + g] = _eval_conv2(h1, a2, b2, k2)
        at, bt, kt = blk["transition"]
        x = _avg_pool_nhwc(_matmul_c(torch.addcmul(bt, buf, at).relu_(), kt), 2)
        al, bl = blk["last_norm"]
        x = torch.addcmul(bl, x, al)
    return _finish(model, plan, x)


def buffer_apply(model: DenseNet, crop: torch.Tensor) -> dict[str, torch.Tensor]:
    """Eval forward of ``model`` (its running statistics, its dtype) through
    the concat-free channels-last buffer: crop (B, H, W, 3) -> the four
    heads, equal to ``model.eval()(crop)`` up to float reassociation."""
    return buffer_forward(model, eval_plan(model), crop)


def _norm_relu_matmul(pieces, offsets, a, b, kernel):
    """sum_i relu(P_i * a_i + b_i) @ K_i over the pieces of a concat: its
    norm + ReLU + 1×1 conv, kernel (C, D), channels at the static offsets."""
    out = None
    for p, o in zip(pieces, offsets):
        c = p.shape[-1]
        t = _matmul_c(torch.addcmul(b[o:o + c], p, a[o:o + c]).relu_(), kernel[o:o + c])
        out = t if out is None else out + t
    return out


@torch.no_grad()
def fast_apply(model: DenseNet, crop: torch.Tensor, group: int = 4) -> dict[str, torch.Tensor]:
    """Eval forward with the dense-block features as a list of pieces (the
    stem's output and one tensor per layer); every consumer of the concat is
    a sum of per-piece products, and every ``group`` consecutive layer
    outputs are compacted into one slab (a group·growth-channel concat)."""
    plan = eval_plan(model)
    g = model.growth_rate
    x = _conv3x3_nhwc(crop.to(plan["dtype"]), plan["conv0"])
    a, b = plan["norm0"]
    pieces, offsets = [torch.addcmul(b, x, a).relu_()], [0]
    num_features = model.num_init_features
    for blk in plan["blocks"]:
        pending: list[int] = []  # layer outputs awaiting slab compaction
        for j, (a1, b1, k1, a2, b2, k2) in enumerate(blk["layers"]):
            h1 = _norm_relu_matmul(pieces, offsets, a1, b1, k1)
            offsets.append(num_features + j * g)
            pieces.append(_eval_conv2(h1, a2, b2, k2))
            pending.append(len(pieces) - 1)
            if len(pending) == group:
                slab = torch.cat([pieces[k] for k in pending], dim=-1)
                pieces = pieces[:pending[0]] + [slab]
                offsets = offsets[:pending[0]] + [offsets[pending[0]]]
                pending = []
        num_features += len(blk["layers"]) * g
        at, bt, kt = blk["transition"]
        x = _avg_pool_nhwc(_norm_relu_matmul(pieces, offsets, at, bt, kt), 2)
        num_features = int(math.floor(num_features * model.compression))
        al, bl = blk["last_norm"]
        pieces, offsets = [torch.addcmul(bl, x, al)], [0]
    return _finish(model, plan, pieces[0])


# -- train ---------------------------------------------------------------------


def _moments(h: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, mean of squares) of an NHWC tensor in float32
    (float64 for float64 h): flax's train-mode statistics; with a group
    the global batch's (emlight_tpu/nn/densenet_fast.py::_batch_stats_nchw
    with its axis_name: one all-reduce of the stacked pair)."""
    hf = h.to(_stat_dtype(h.dtype))
    dims = tuple(range(h.dim() - 1))
    return global_moments(hf.mean(dims), (hf * hf).mean(dims), group)


def _affine(mu, mu2, scale, bias, eps: float):
    """Train-mode BatchNorm from precomputed moments as the per-channel
    affine (mul, shift), y = x * mul + shift: var = max(0, mu2 - mu²),
    mul = rsqrt(var + eps) * scale, shift = bias - mu * mul."""
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return mul, bias - mu * mul


def _pre_act(xs: torch.Tensor, mul: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """norm1 before its ReLU, in the statistics' type."""
    return torch.addcmul(shift, xs.to(mul.dtype), mul)


def _norm_train(h, mu, mu2, bn, dt, eps: float, relu: bool = False):
    """Train-mode BatchNorm of NHWC h from precomputed moments, flax's
    formula: (h - mean) * (rsqrt(var + eps) * scale) + bias in the
    statistics' type, rounded to the compute dtype, ReLU optional.
    Returns (y, the batch variance)."""
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * bn.weight
    y = ((h.to(mu.dtype) - mu) * mul + bn.bias).to(dt)
    return (F.relu(y) if relu else y), var


def _route(g: torch.Tensor, x: torch.Tensor, g_mu, g_mu2, ranks: int = 1) -> torch.Tensor:
    """g += g_mu / N + 2 x g_mu2 / N in place: the cotangents of x's
    per-channel mean and mean of squares (over N = B·H·W times the rank
    count: the global batch's moments) routed onto x. A cotangent that is
    None adds nothing."""
    n = x.numel() // x.shape[-1] * ranks
    if g_mu2 is not None:
        g.addcmul_(x, g_mu2 * (2.0 / n))
    if g_mu is not None:
        g.add_(g_mu / n)
    return g


def _summed(group, a, b):
    """The cotangents (a, b) of global moments summed over the ranks (one
    all-reduce of the pair): every rank's loss reads the global moments,
    so each rank's part of their cotangent is added up before it is routed
    onto the rank's rows. Unchanged without a group; None stays None."""
    if group is None or a is None:
        return a, b
    both = all_reduce_sum_(torch.stack([a, b]), group)
    return both[0], both[1]


def _affine_vjp(mu, mu2, scale, g_mul, g_shift, eps: float):
    """The cotangents of ``_affine``'s inputs (mu, mu2, scale, bias) from
    those of its outputs (mul, shift), in closed form: shift = bias - mu *
    mul, mul = r * scale, r = rsqrt(max(0, mu2 - mu²) + eps)."""
    var = mu2 - mu * mu
    r = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    g_mul = g_mul - mu * g_shift
    g_var = torch.where(var >= 0, g_mul * scale * (-0.5) * r * r * r, 0.0)
    return -(r * scale) * g_shift - 2.0 * mu * g_var, g_var, g_mul * r, g_shift


class _DenseBlock(torch.autograd.Function):
    """One dense block of the train forward, its backward the structured VJP
    of emlight_tpu/nn/densenet_fast.py::_block_core.

    apply(x, spec, *lparams): x (B, H, W, C0) in the compute dtype, spec =
    (num_layers, growth_rate, eps, group), lparams per layer (norm1 scale,
    bias, conv1 (cin, 48), norm2 scale, bias, conv2 HWIO). Returns (buf (B,
    H, W, C0 + L·g), mu_all, mu2_all (C0 + L·g,), the norm2 moments n2mu,
    n2mu2 (L, 48)); the moments are float32 (float64 for float64 x).

    With a group (a dist/mesh.py RankGroup) every moment is the global
    batch's: the forward all-reduces each plane's moments as it writes the
    plane, and the backward sums each moment cotangent over the ranks
    before routing it with N the global count: the block's input
    cotangent, and one pair per norm of each layer, about two small
    all-reduces a layer. (The JAX package's _block_core scales N by the
    axis size but never sums the cotangents, so its parallel gradient is
    not the global batch's; ROADMAP.md §3.)"""

    @staticmethod
    def forward(ctx, x, spec, *lparams):
        num_layers, g, eps, group = spec
        dt = x.dtype
        bsz, hh, ww, c0 = x.shape
        total = c0 + num_layers * g
        buf = x.new_empty(bsz, hh, ww, total)
        buf[..., :c0] = x
        mu_all = x.new_empty(total, dtype=_stat_dtype(dt))
        mu2_all = torch.empty_like(mu_all)
        mu_all[:c0], mu2_all[:c0] = _moments(x, group)
        h1s, n2mu, n2mu2 = [], [], []
        for j in range(num_layers):
            cin = c0 + j * g
            s1, b1, k1, s2, b2, k2 = lparams[6 * j:6 * j + 6]
            mul, shift = _affine(mu_all[:cin], mu2_all[:cin], s1, b1, eps)
            y1 = _pre_act(buf[..., :cin], mul, shift).relu_().to(dt)
            h1 = _matmul_c(y1, k1.to(dt))
            del y1
            m2, m22 = _moments(h1, group)
            a2, c2 = _affine(m2, m22, s2, b2, eps)
            h = dense_conv_fwd(h1, a2, c2, k2.to(dt).contiguous()).to(dt)
            buf[..., cin:cin + g] = h
            mu_all[cin:cin + g], mu2_all[cin:cin + g] = _moments(h, group)
            h1s.append(h1)
            n2mu.append(m2)
            n2mu2.append(m22)
        n2mu, n2mu2 = torch.stack(n2mu), torch.stack(n2mu2)
        ctx.spec = spec
        ctx.save_for_backward(buf, mu_all, mu2_all, n2mu, n2mu2, *h1s, *lparams)
        return buf, mu_all, mu2_all, n2mu, n2mu2

    @staticmethod
    def backward(ctx, g_buf, g_mu_all, g_mu2_all, g_n2mu, g_n2mu2):
        num_layers, g, eps, group = ctx.spec
        ranks = 1 if group is None else group.size
        buf, mu_all, mu2_all, n2mu, n2mu2, *rest = ctx.saved_tensors
        h1s, lparams = rest[:num_layers], rest[num_layers:]
        dt = buf.dtype
        c0 = buf.shape[-1] - num_layers * g
        # moment cotangents from the block's consumers (the transition's
        # norm) route straight onto the planes of the final buffer
        g_acc = torch.zeros_like(buf) if g_buf is None else g_buf.to(dt).contiguous().clone()
        _route(g_acc, buf, *_summed(group, g_mu_all, g_mu2_all), ranks)
        g_lparams = [None] * len(lparams)
        for j in reversed(range(num_layers)):
            cin = c0 + j * g
            s1, b1, k1, s2, b2, k2 = lparams[6 * j:6 * j + 6]
            h1 = h1s[j]
            k1c, k2c = k1.to(dt), k2.to(dt).contiguous()
            # stage b: norm2 (affine a2, c2 from h1's moments) -> conv2
            g_h = g_acc[..., cin:cin + g].contiguous()
            m2, m22 = n2mu[j], n2mu2[j]
            a2, c2 = _affine(m2, m22, s2, b2, eps)
            dx, da, db = dense_conv_dx(g_h, h1, a2, k2c)
            dk2 = dense_conv_dk(h1, g_h, a2, c2)
            g_m2, g_m22, g_s2, g_b2 = _affine_vjp(m2, m22, s2, da.to(a2.dtype), db.to(a2.dtype),
                                                  eps)
            if g_n2mu is not None:
                g_m2, g_m22 = g_m2 + g_n2mu[j], g_m22 + g_n2mu2[j]
            g_h1 = _route(dx.to(_stat_dtype(dt)), h1, *_summed(group, g_m2, g_m22), ranks).to(dt)
            del dx
            # stage a: norm1 + ReLU -> conv1, recomputed from the final buffer
            xs = buf[..., :cin]
            mu1, mu21 = mu_all[:cin], mu2_all[:cin]
            mul, shift = _affine(mu1, mu21, s1, b1, eps)
            pre = _pre_act(xs, mul, shift)
            g2 = g_h1.reshape(-1, g_h1.shape[-1])
            dk1 = F.relu(pre).to(dt).reshape(-1, cin).t() @ g2
            dpre = torch.ops.aten.threshold_backward(
                (g2 @ k1c.t()).view(pre.shape).to(pre.dtype), pre, 0)
            del pre
            xf = xs.to(dpre.dtype)
            d_mul, d_shift = (dpre * xf).sum((0, 1, 2)), dpre.sum((0, 1, 2))
            g_mu1, g_mu21, g_s1, g_b1 = _affine_vjp(mu1, mu21, s1, d_mul, d_shift, eps)
            # dx = dpre * mul and norm1's moments, on contiguous dpre; then
            # one strided add into the layer's input planes
            g_acc[..., :cin] += _route(dpre.mul_(mul), xf, *_summed(group, g_mu1, g_mu21),
                                       ranks).to(dt)
            del dpre
            g_lparams[6 * j:6 * j + 6] = (g_s1, g_b1, dk1.to(k1.dtype), g_s2, g_b2,
                                          dk2.to(k2.dtype))
        return (g_acc[..., :c0], None, *g_lparams)


def _block_plain(x, spec, *lparams):
    """``_DenseBlock``'s function under plain autograd, out of place: each
    layer concatenates the planes written so far (block_vjp=False)."""
    num_layers, g, eps, group = spec
    dt = x.dtype
    planes, mus, mu2s = [x], *[[m] for m in _moments(x, group)]
    n2mu, n2mu2 = [], []
    for j in range(num_layers):
        s1, b1, k1, s2, b2, k2 = lparams[6 * j:6 * j + 6]
        mul, shift = _affine(torch.cat(mus), torch.cat(mu2s), s1, b1, eps)
        h1 = _matmul_c(F.relu(_pre_act(torch.cat(planes, dim=-1), mul, shift)).to(dt), k1.to(dt))
        m2, m22 = _moments(h1, group)
        a2, c2 = _affine(m2, m22, s2, b2, eps)
        h = fused_affine_conv3x3(h1, a2, c2, k2)
        m, mq = _moments(h, group)
        planes.append(h)
        mus.append(m)
        mu2s.append(mq)
        n2mu.append(m2)
        n2mu2.append(m22)
    return (torch.cat(planes, dim=-1), torch.cat(mus), torch.cat(mu2s), torch.stack(n2mu),
            torch.stack(n2mu2))


@torch.no_grad()
def _ra_update(bn, mu, var, momentum: float) -> None:
    """flax BatchNorm's running-average update, in place."""
    rm, rv = bn.running_stats()
    rm.mul_(momentum).add_(mu.to(rm.dtype), alpha=1.0 - momentum)
    rv.mul_(momentum).add_(var.to(rv.dtype), alpha=1.0 - momentum)


def train_apply(model: DenseNet, crop: torch.Tensor, *, momentum: float = 0.9,
                eps: float = 1e-5, block_vjp: bool = True) -> dict[str, torch.Tensor]:
    """The concat-free TRAIN forward of ``model`` in its dtype: crop (B, H,
    W, 3) -> the four heads, differentiable in every parameter; the running
    statistics are updated in place. Equal to ``model.train()(crop)`` up to
    float reassociation, with each plane's batch moments computed once.
    block_vjp=False runs the blocks under plain autograd instead of
    ``_DenseBlock``'s backward. Under ``model.group`` every moment is the
    global batch's over the ranks (``_DenseBlock``)."""
    dt = model.dtype
    g = model.growth_rate
    group = model.group
    x = _conv3x3_nhwc(crop.to(dt), model.conv0.weight)
    mu, mu2 = _moments(x, group)
    x, var = _norm_train(x, mu, mu2, model.norm0, dt, eps, relu=True)
    _ra_update(model.norm0, mu, var, momentum)
    num_features = model.num_init_features
    for i, num_layers in enumerate(model.block_config, start=1):
        lparams = []
        for j in range(1, num_layers + 1):
            layer = model.dense_layer(i, j)
            lparams += [layer.norm1.weight, layer.norm1.bias, _conv1x1_kernel(layer.conv1),
                        layer.norm2.weight, layer.norm2.bias, _conv3x3_kernel(layer.conv2)]
        spec = (num_layers, g, eps, group)
        block = _DenseBlock.apply if block_vjp else _block_plain
        buf, mu_all, mu2_all, n2mu, n2mu2 = block(x, spec, *lparams)
        with torch.no_grad():
            for j in range(num_layers):
                cin = num_features + j * g
                layer = model.dense_layer(i, j + 1)
                m1, m21 = mu_all[:cin], mu2_all[:cin]
                _ra_update(layer.norm1, m1, torch.clamp(m21 - m1 * m1, min=0.0), momentum)
                _ra_update(layer.norm2, n2mu[j], torch.clamp(n2mu2[j] - n2mu[j] ** 2, min=0.0),
                           momentum)
        num_features += num_layers * g
        tr = getattr(model, f"transition{i}")
        x, vart = _norm_train(buf, mu_all, mu2_all, tr.norm, dt, eps, relu=True)
        _ra_update(tr.norm, mu_all, vart, momentum)
        x = _avg_pool_nhwc(_matmul_c(x, _conv1x1_kernel(tr.conv).to(dt)), 2)
        num_features = int(math.floor(num_features * model.compression))
        last = getattr(model, f"last_norm{i}")
        mu, mu2 = _moments(x, group)
        x, var = _norm_train(x, mu, mu2, last, dt, eps)
        _ra_update(last, mu, var, momentum)
    x = _avg_pool_nhwc(F.relu(x), model.avgpool_size).flatten(1)
    return heads_f32(model, F.linear(x, model.fc.weight.to(dt), model.fc.bias.to(dt)))
