"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. This file imports no JAX, so it runs where only PyTorch is
installed (``--noconftest``: the suite's conftest imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every test skips on a machine without a CUDA device (a CUDA kernel has no
CPU mode)."""

import numpy as np
import pytest
import torch

from emlight_tpu_torch.nn import dense_conv as tdc
from emlight_tpu_torch.nn import dense_conv_kernel as tdk
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from emlight_tpu_torch.nn import sphere_conv_vjp as tvjp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _inputs(shape, cout, device, seed=0):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.random(shape, dtype=np.float32)
    k = rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, k, bias))


# main-path extremes (4x8 1024->1024, cin=3, cout=3, 128x256) and ragged
# widths no tile divides (W < 8, cin and cout off the 16/64 tiles)
SHAPES = [((2, 4, 8, 1024), 1024), ((2, 32, 64, 3), 384), ((2, 128, 256, 64), 3),
          ((2, 16, 32, 128), 2048), ((3, 8, 4, 20), 70), ((1, 5, 1, 17), 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", SHAPES)
def test_kernel_matches_plain(card, dtype, shape, cout):
    x, k, bias = _inputs(shape, cout, card)
    dt = getattr(torch, dtype)
    x, k = x.to(dt), k.to(dt)
    before = tker.sphere_conv_s1.launches
    out = tsc.sphere_conv(x, k, bias)
    torch.cuda.synchronize()
    assert tker.sphere_conv_s1.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (*shape[:3], cout)
    ref = tsc.sphere_conv_plain(x, k, bias)
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


# B1's tile and split plan on the card: the 4x8 1024 -> 1024 conv of the
# generator at its batch 8 (K split 17 ways), and tiles that cross rows and
# images on a ragged map
S1_PLAN_SHAPES = [((8, 4, 8, 1024), 1024), ((3, 5, 7, 20), 70)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", S1_PLAN_SHAPES)
def test_kernel_plan_shapes_match_plain(card, dtype, shape, cout):
    plan = tker.s1_plan(*shape, cout)
    assert (plan.n_split > 1) == (shape[1] == 4)
    x, k, bias = _inputs(shape, cout, card, seed=5)
    dt = getattr(torch, dtype)
    x, k = x.to(dt), k.to(dt)
    before = tker.sphere_conv_s1.launches
    out = tker.sphere_conv_s1(x, k, bias)
    torch.cuda.synchronize()
    assert tker.sphere_conv_s1.launches == before + 1
    ref = tsc.sphere_conv_plain(x, k, bias)
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_split_k_is_deterministic(card):
    """The split partials are summed in split order: two runs, same bits."""
    x, k, bias = _inputs((8, 4, 8, 1024), 1024, card, seed=6)
    assert tker.s1_plan(8, 4, 8, 1024, 1024).n_split > 1
    first = tker.sphere_conv_s1(x, k, bias)
    second = tker.sphere_conv_s1(x, k, bias)
    assert torch.equal(first, second)


def test_kernel_without_bias(card):
    x, k, _ = _inputs((2, 8, 16, 32), 40, card)
    torch.testing.assert_close(tsc.sphere_conv(x, k, None), tsc.sphere_conv_plain(x, k, None),
                               rtol=1e-4, atol=1e-4)


def test_stride3_on_card_raises(card):
    x, k, bias = _inputs((1, 16, 32, 8), 8, card)
    with pytest.raises(ValueError, match="stride"):
        tsc.sphere_conv(x, k, bias, 3)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, k, bias = _inputs((1, 8, 16, 8), 8, card)
    with pytest.raises(TypeError):
        tker.sphere_conv_s1(x, k.bfloat16(), bias)
    with pytest.raises(TypeError):
        tker.sphere_conv_s1(x.half(), k.half(), bias)
    with pytest.raises(ValueError):
        tker.sphere_conv_s1(x.transpose(1, 2), k, bias)
    with pytest.raises(ValueError):
        tker.sphere_conv_s1(x, k[:, :, :4], bias)
    with pytest.raises(ValueError):
        tker.sphere_conv_s1(x, k, bias.cpu())


def _close(out, ref, dtype, rtol=1e-4, atol=1e-4):
    """f32: the stated rtol/atol; bf16: within 2e-2 of max|ref|."""
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    else:
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


# the discriminator's stride-2 shapes (cin 6 front at 128x256 and 64x128,
# 64 -> 128 and 128 -> 256 on both scales; the last at its batch 16, where
# B2 splits K 9 ways), --crop_size 512's front conv (a 256x512 map) and
# ragged widths
S2_SHAPES = [((2, 128, 256, 6), 64), ((2, 64, 128, 6), 64), ((2, 64, 128, 64), 128),
             ((2, 32, 64, 64), 128), ((2, 32, 64, 128), 256), ((2, 16, 32, 128), 256),
             ((16, 16, 32, 128), 256), ((2, 256, 512, 6), 64), ((3, 8, 16, 20), 70)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", S2_SHAPES)
def test_stride2_kernel_matches_plain(card, dtype, shape, cout):
    x, k, bias = _inputs(shape, cout, card)
    dt = getattr(torch, dtype)
    x, k = x.to(dt), k.to(dt)
    before = tker.sphere_conv_s2.launches
    out = tsc.sphere_conv(x, k, bias, 2)
    torch.cuda.synchronize()
    assert tker.sphere_conv_s2.launches == before + 1
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2, cout)
    _close(out, tsc.sphere_conv_plain(x, k, bias, 2), dtype)


# B2 where it splits K and stages its source rows (128 -> 256 at batch 16)
# and where it gathers from device memory (cin 6)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((16, 32, 64, 128), 256), ((2, 128, 256, 6), 64)])
def test_stride2_kernel_is_deterministic(card, dtype, shape, cout):
    x, k, bias = _inputs(shape, cout, card, seed=11)
    dt = getattr(torch, dtype)
    x, k = x.to(dt), k.to(dt)
    assert (tker.s1_plan(*shape, cout, dt, stride=2).n_split > 1) == (shape[-1] == 128)
    assert torch.equal(tker.sphere_conv_s2(x, k, bias), tker.sphere_conv_s2(x, k, bias))


# (x shape, cout, stride): cin 3/6 and cout 3, 8x16 maps, and a wide 4x8 map
GRAD_SHAPES = [((2, 128, 256, 3), 384, 1), ((2, 128, 256, 64), 3, 1), ((2, 4, 8, 1024), 1024, 1),
               ((2, 16, 32, 512), 3, 1), ((2, 8, 16, 256), 512, 1), ((2, 64, 128, 128), 256, 1),
               ((2, 128, 256, 6), 64, 2), ((2, 64, 128, 64), 128, 2), ((2, 16, 32, 128), 256, 2),
               ((3, 8, 16, 20), 70, 2), ((3, 8, 16, 20), 70, 1)]


def _grad_inputs(shape, cout, stride, device, seed=1, mean_loss=False):
    """x, kernel and a standard-normal cotangent g; with mean_loss, g is
    scaled by 1/sqrt(output pixels), the size of a loss averaged over them,
    so dK stays O(1) however many pixels it sums over."""
    x, k, _ = _inputs(shape, cout, device, seed)
    rng = np.random.default_rng(seed + 1)
    g_shape = (shape[0], shape[1] // stride, shape[2] // stride, cout)
    g = rng.standard_normal(g_shape).astype(np.float32)
    if mean_loss:
        g /= np.sqrt(np.prod(g_shape[:3]))
    return x, k, torch.from_numpy(g).to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride", GRAD_SHAPES)
def test_dx_kernel_matches_plain(card, dtype, shape, cout, stride):
    x, k, g = _grad_inputs(shape, cout, stride, card)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    small = shape[1] * shape[2] < tker.UMAJOR_MIN_PIXELS
    counter = (tker.sphere_conv_dx_s2 if stride == 2 else
               tker.sphere_conv_dx_s1_triple if small else tker.sphere_conv_dx_s1)
    before = counter.launches
    dx = tker.sphere_conv_dx(g, k, tuple(x.shape), stride)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    _close(dx, tvjp.dx_plain(g, k, tuple(x.shape), stride), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride", GRAD_SHAPES)
def test_dk_kernel_matches_plain(card, dtype, shape, cout, stride):
    x, _, g = _grad_inputs(shape, cout, stride, card, mean_loss=True)
    dt = getattr(torch, dtype)
    x, g = x.to(dt), g.to(dt)
    before = tker.sphere_conv_dk.launches
    dk = tker.sphere_conv_dk(x, g, stride)
    torch.cuda.synchronize()
    assert tker.sphere_conv_dk.launches == before + 1
    assert dk.dtype == torch.float32 and dk.shape == (3, 3, shape[-1], cout)
    # the sums over pixels run in another order (chunked partials against
    # one matmul): rtol 1e-3, as tests/test_sphere_conv_vjp.py:132 holds _dk_pallas
    _close(dk, tvjp.dk_plain(x, g, stride), dtype, rtol=1e-3, atol=1e-4)


def test_dk_kernel_is_deterministic(card):
    x, _, g = _grad_inputs((2, 64, 128, 64), 128, 1, card)
    assert tker.dk_plan(2 * 64 * 128, 64, 128).n_chunks > 1
    a = tker.sphere_conv_dk(x, g, 1)
    b = tker.sphere_conv_dk(x, g, 1)
    assert torch.equal(a, b)


# the tensor-core B4 and B3 at their ragged edges: cin 3 -> 384 (all taps
# in one block row) and cin 6 at stride 2 for B4, 64 -> 3 for both (a K of
# 27 for B3, one 32-channel block for B4), a 4x8 map at B4's full width,
# and pixels, channels and rows off every tile
TC_RAGGED = [((2, 32, 64, 3), 384, 1), ((2, 64, 128, 6), 64, 2), ((2, 128, 256, 64), 3, 1),
             ((8, 4, 8, 1024), 1024, 1), ((3, 5, 7, 20), 70, 1), ((1, 6, 10, 9), 5, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride", TC_RAGGED)
def test_tc_dk_matches_plain_at_ragged_shapes(card, dtype, shape, cout, stride):
    x, _, g = _grad_inputs(shape, cout, stride, card, seed=3, mean_loss=True)
    dt = getattr(torch, dtype)
    x, g = x.to(dt), g.to(dt)
    before = tker.sphere_conv_dk.launches
    dk = tker.sphere_conv_dk(x, g, stride)
    torch.cuda.synchronize()
    assert tker.sphere_conv_dk.launches == before + 1
    _close(dk, tvjp.dk_plain(x, g, stride), dtype, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride", [sc for sc in TC_RAGGED if sc[2] == 1])
def test_tc_dx_s1_matches_plain_at_ragged_shapes(card, dtype, shape, cout, stride):
    x, k, g = _grad_inputs(shape, cout, 1, card, seed=4)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    before = tker.sphere_conv_dx_s1.launches
    dx = tker.sphere_conv_dx_s1(g, k, tuple(x.shape))
    torch.cuda.synchronize()
    assert tker.sphere_conv_dx_s1.launches == before + 1
    _close(dx, tvjp.dx_plain(g, k, tuple(x.shape), 1), dtype)


def test_dx_s1_kernel_is_deterministic(card):
    x, k, g = _grad_inputs((2, 64, 128, 128), 256, 1, card)
    a = tker.sphere_conv_dx_s1(g, k, tuple(x.shape))
    b = tker.sphere_conv_dx_s1(g, k, tuple(x.shape))
    assert torch.equal(a, b)


def test_dx_s1_skips_the_dead_column(card):
    """An inf in g reaches no dx value through the dead column: wherever
    the plain version is finite, B3 is too."""
    x, k, g = _grad_inputs((1, 32, 64, 8), 8, 1, card)
    g[0, 0, 5, 2] = float("inf")
    g[0, 31, 40, 1] = float("inf")
    dx = tker.sphere_conv_dx_s1(g, k, tuple(x.shape))
    ref = tvjp.dx_plain(g, k, tuple(x.shape), 1)
    assert torch.equal(torch.isfinite(dx), torch.isfinite(ref))


@pytest.mark.parametrize("stride", [1, 2])
def test_function_backward_uses_the_kernels(card, stride):
    """SphereConvFunction on the card: dx, dK and db against autograd of the
    plain forward, each kernel launched once."""
    x, k, bias = _inputs((2, 16, 32, 8), 12, card)
    x, k, bias = (t.requires_grad_() for t in (x, k, bias))
    tgt = torch.rand(2, 16 // stride, 32 // stride, 12, device=card)
    counters = (tker.sphere_conv_s1 if stride == 1 else tker.sphere_conv_s2,
                tker.sphere_conv_dx_s1_triple if stride == 1 else tker.sphere_conv_dx_s2,
                tker.sphere_conv_dk)
    before = [c.launches for c in counters]
    got = torch.autograd.grad(((tsc.sphere_conv(x, k, bias, stride) - tgt) ** 2).sum(),
                              (x, k, bias))
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref = torch.autograd.grad(((tsc.sphere_conv_plain(x, k, bias, stride) - tgt) ** 2).sum(),
                              (x, k, bias))
    for a, b_ in zip(got, ref):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)


def test_function_backward_on_a_large_map_uses_b3_and_b4(card):
    """A map of at least UMAJOR_MIN_PIXELS (128x256): SphereConvFunction's
    backward launches B3 for dx and B4 for dK, once each, and nothing else
    of the backward."""
    assert 128 * 256 >= tker.UMAJOR_MIN_PIXELS
    x, k, bias = _inputs((2, 128, 256, 8), 12, card)
    x, k, bias = (t.requires_grad_() for t in (x, k, bias))
    tgt = torch.rand(2, 128, 256, 12, device=card)
    counters = (tker.sphere_conv_s1, tker.sphere_conv_dx_s1, tker.sphere_conv_dk,
                tker.sphere_conv_dx_s1_triple, tker.sphere_conv_dx_s2)
    before = [c.launches for c in counters]
    got = torch.autograd.grad(((tsc.sphere_conv(x, k, bias, 1) - tgt) ** 2).sum(), (x, k, bias))
    assert [c.launches for c in counters] == [n + d for n, d in zip(before, (1, 1, 1, 0, 0))]
    ref = torch.autograd.grad(((tsc.sphere_conv_plain(x, k, bias, 1) - tgt) ** 2).sum(),
                              (x, k, bias))
    for a, b_ in zip(got, ref):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)


def test_grad_wrappers_reject_what_the_kernels_do_not_take(card):
    x, k, g = _grad_inputs((1, 8, 16, 8), 8, 1, card)
    with pytest.raises(TypeError):
        tker.sphere_conv_dx(g, k.bfloat16(), tuple(x.shape), 1)
    with pytest.raises(ValueError):
        tker.sphere_conv_dx(g, k, (1, 8, 16, 8), 2)
    with pytest.raises(ValueError):
        tker.sphere_conv_dk(x, g.transpose(1, 2), 1)
    with pytest.raises(ValueError):
        tker.sphere_conv_dk(x, g, 3)
    with pytest.raises(ValueError):
        tker.sphere_conv_s2(x[:, :7], k[:, :, :8], None)


# B3 and B6 each at every stride-1 gradient shape, whichever of the two the
# routing picks
S1_SHAPES = [sc for sc in GRAD_SHAPES if sc[2] == 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride", S1_SHAPES)
def test_dx_b3_and_b6_match_plain(card, dtype, shape, cout, stride):
    x, k, g = _grad_inputs(shape, cout, stride, card)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    ref = tvjp.dx_plain(g, k, tuple(x.shape), 1)
    for fn in (tker.sphere_conv_dx_s1, tker.sphere_conv_dx_s1_triple):
        before = fn.launches
        dx = fn(g, k, tuple(x.shape))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _close(dx, ref, dtype)


# --crop_size 512's outer stride-1 convs (a 256x512 map: B3 reads its g
# rows from device memory, two buffers of them do not fit in shared memory)
WIDE_SHAPES = [((2, 256, 512, 64), 3), ((2, 256, 512, 128), 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", WIDE_SHAPES)
def test_dx_s1_takes_maps_wider_than_256(card, dtype, shape, cout):
    x, k, g = _grad_inputs(shape, cout, 1, card, seed=7)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    before = tker.sphere_conv_dx_s1.launches
    dx = tker.sphere_conv_dx(g, k, tuple(x.shape), 1)
    torch.cuda.synchronize()
    assert tker.sphere_conv_dx_s1.launches == before + 1
    _close(dx, tvjp.dx_plain(g, k, tuple(x.shape), 1), dtype)


def test_dx_s1_bf16_keeps_the_regrouped_operand_to_f32(card):
    """B3 splits Ĝ into bf16 hi + lo, so its bf16 dx tracks the plain
    version (U in f32) far inside the 2e-2 bar: within 1e-3 of max|ref|,
    where rounding Ĝ to one bf16 gave 2.2e-3."""
    x, k, g = _grad_inputs((2, 64, 128, 128), 256, 1, card, seed=8)
    g, k = g.bfloat16(), k.bfloat16()
    dx = tker.sphere_conv_dx_s1(g, k, tuple(x.shape))
    ref = tvjp.dx_plain(g, k, tuple(x.shape), 1)
    assert (dx - ref).abs().max() <= 1e-3 * ref.abs().max()


# every stride-1 dx shape of the training path on the small maps: the
# generator's (mlp_gammabeta 128 -> 2C, conv_0, conv_1, conv_s) at the G
# step's batch 8, the discriminator's at its batch 16; and ragged ones (cin
# and cout off the 64 x 128 x 32 tiles, cout 3, W off the 64-pixel tile)
B6_SHAPES = [((8, 4, 8, 128), 2048), ((8, 4, 8, 1024), 1024), ((8, 8, 16, 128), 2048),
             ((8, 8, 16, 1024), 1024), ((8, 16, 32, 128), 2048), ((8, 16, 32, 128), 1024),
             ((8, 16, 32, 1024), 512), ((8, 16, 32, 512), 512), ((16, 8, 16, 256), 512),
             ((16, 8, 16, 512), 3), ((16, 16, 32, 256), 512), ((16, 16, 32, 512), 3),
             ((3, 5, 7, 20), 70), ((1, 6, 10, 9), 5), ((2, 4, 8, 3), 3), ((1, 8, 12, 130), 33)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", B6_SHAPES)
def test_dx_triple_matches_plain(card, dtype, shape, cout):
    x, k, g = _grad_inputs(shape, cout, 1, card, seed=9)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    before = tker.sphere_conv_dx_s1_triple.launches
    dx = tker.sphere_conv_dx_s1_triple(g, k, tuple(x.shape))
    torch.cuda.synchronize()
    assert tker.sphere_conv_dx_s1_triple.launches == before + 1
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    _close(dx, tvjp.dx_plain(g, k, tuple(x.shape), 1), dtype)


def test_dx_triple_is_deterministic(card):
    """The 4x8 128 -> 2048 conv cuts K into U partials, summed in split
    order by the gather: two runs, same bits."""
    assert tker.triple_tiles(8, 4, 8, 128, 2048).n_split > 1
    x, k, g = _grad_inputs((8, 4, 8, 128), 2048, 1, card, seed=10)
    a = tker.sphere_conv_dx_s1_triple(g, k, tuple(x.shape))
    b = tker.sphere_conv_dx_s1_triple(g, k, tuple(x.shape))
    assert torch.equal(a, b)


def test_dx_triple_skips_padded_slots(card):
    """An inf in g reaches no dx value through a padded (weight 0) slot or
    the dead column: wherever the plain version is finite, B6 is too."""
    x, k, g = _grad_inputs((1, 8, 16, 8), 8, 1, card)
    g[0, 3, 5, 2] = float("inf")
    dx = tker.sphere_conv_dx_s1_triple(g, k, tuple(x.shape))
    ref = tvjp.dx_plain(g, k, tuple(x.shape), 1)
    assert torch.equal(torch.isfinite(dx), torch.isfinite(ref))


# B5 (the stride-2 instance of B6's kernels) at ragged widths: Cin 5, 6 and
# 9 (the value-by-value gather), 130 (float4 chunks, N off the 128-row tile),
# Cout 3 and 70 (a ragged K step; K cut at these batches), and
# --crop_size 512's front conv (a 256x512 input, 6 -> 64)
B5_SHAPES = [((2, 16, 32, 5), 3), ((2, 16, 32, 6), 70), ((3, 8, 16, 9), 70),
             ((2, 8, 16, 130), 3), ((2, 32, 64, 130), 70), ((2, 256, 512, 6), 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", B5_SHAPES)
def test_dx_s2_matches_plain_at_ragged_widths(card, dtype, shape, cout):
    x, k, g = _grad_inputs(shape, cout, 2, card, seed=11)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    before = tker.sphere_conv_dx_s2.launches
    dx = tker.sphere_conv_dx(g, k, tuple(x.shape), 2)
    torch.cuda.synchronize()
    assert tker.sphere_conv_dx_s2.launches == before + 1
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    _close(dx, tvjp.dx_plain(g, k, tuple(x.shape), 2), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_s2_is_deterministic(card, dtype):
    """The 32x64 128 -> 256 conv at batch 2 cuts K into U partials, summed in
    split order by the gather: two runs, same bits."""
    assert tker.triple_tiles(2, 16, 32, 128, 256).n_split > 1
    x, k, g = _grad_inputs((2, 32, 64, 128), 256, 2, card, seed=12)
    dt = getattr(torch, dtype)
    g, k = g.to(dt), k.to(dt)
    a = tker.sphere_conv_dx_s2(g, k, tuple(x.shape))
    b = tker.sphere_conv_dx_s2(g, k, tuple(x.shape))
    assert torch.equal(a, b)


@pytest.mark.parametrize("cin", [8, 6])
def test_dx_s2_skips_padded_slots(card, cin):
    """An inf in g reaches no dx value through a padded (weight 0) slot or
    the dead column, on the float4 and the value-by-value gather: wherever
    the plain version is finite, B5 is too."""
    x, k, g = _grad_inputs((1, 8, 16, cin), 8, 2, card)
    g[0, 2, 5, 3] = float("inf")
    dx = tker.sphere_conv_dx_s2(g, k, tuple(x.shape))
    ref = tvjp.dx_plain(g, k, tuple(x.shape), 2)
    assert torch.equal(torch.isfinite(dx), torch.isfinite(ref))


def test_dx_s2_raises_when_the_entry_fails_and_never_takes_dx_plain(card, monkeypatch):
    """A CUDA g takes the kernel or raises: an error code from the entry
    point becomes a RuntimeError, counts no launch, and dx_plain is not
    called."""
    x, k, g = _grad_inputs((2, 16, 32, 8), 8, 2, card)

    def no_plain(*args, **kwargs):
        raise AssertionError("dx_plain reached with a CUDA tensor")

    monkeypatch.setattr(tker, "entry", lambda *args: (lambda *call: 1))
    monkeypatch.setattr(tvjp, "dx_plain", no_plain)
    before = tker.sphere_conv_dx_s2.launches
    with pytest.raises(RuntimeError, match="sphere_conv_dx_s2 launch failed"):
        tker.sphere_conv_dx(g, k, tuple(x.shape), 2)
    assert tker.sphere_conv_dx_s2.launches == before


def test_dx_triple_entry_rejects_what_the_kernels_do_not_take(card):
    """The C entry returns cudaErrorInvalidValue (1), launching nothing, for
    a stride other than 1 or 2, H or W not a multiple of the stride, and a
    slot list longer than its 64 shared-memory slots."""
    from emlight_tpu_torch.nn.kernel_launch import entry

    fn = entry("sphere_conv_dx_triple", "sphere_conv_dx_triple", torch.float32, 9, 9)
    # g, kmat, the five slot tables, u and dx: zeros, so every slot is padding
    bufs = [torch.zeros(1 << 12, device=card) for _ in range(9)]
    stream = torch.cuda.current_stream(card).cuda_stream

    def call(h, w, stride, fanin):
        # B, H, W, Cin, Cout, stride, fanin, per, n_split
        return fn(*[t.data_ptr() for t in bufs], 1, h, w, 4, 4, stride, fanin, 32, 1, stream)

    assert call(8, 16, 2, 13) == 0
    torch.cuda.synchronize()
    assert call(8, 16, 3, 13) == 1
    assert call(8, 16, 0, 13) == 1
    assert call(7, 16, 2, 13) == 1
    assert call(8, 15, 2, 13) == 1
    assert call(8, 16, 2, 65) == 1
    assert call(8, 16, 1, 65) == 1


# the regression step's three dense-layer shapes (48 -> 12 channels) at
# batch 2, one at batch 16, and ragged ones: h = 8 (one row tile), h and w
# off the 8 x 32 tile, cin 5 -> cout 3, one pixel
DENSE_SHAPES = [((2, 192, 256, 48), 12), ((2, 96, 128, 48), 12), ((2, 48, 64, 48), 12),
                ((16, 48, 64, 48), 12), ((2, 8, 16, 48), 12), ((2, 10, 12, 5), 3),
                ((3, 13, 37, 20), 7), ((1, 1, 1, 3), 2)]


def _dense_inputs(shape, cout, device, seed=2):
    """x, a, b, kernel and a cotangent g scaled as the gradient of a loss
    averaged over the output (so dK, da and db stay O(1))."""
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    arrays = (rng.standard_normal(shape), rng.uniform(0.5, 1.5, cin), rng.normal(0, 0.3, cin),
              rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)),
              rng.standard_normal((*shape[:3], cout)) / np.sqrt(np.prod(shape[:3])))
    return (torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", DENSE_SHAPES)
def test_dense_conv_kernels_match_plain(card, dtype, shape, cout):
    """B7, B7' (dx, da, db) and B8 against their plain versions: f32 at
    rtol = atol = 1e-4, the long sums over pixels (dK, da, db) at rtol 1e-3;
    bf16 within 2e-2 of max|ref|."""
    x, a, b, k, g = _dense_inputs(shape, cout, card)
    dt = getattr(torch, dtype)
    x, k, g = x.to(dt), k.to(dt), g.to(dt)
    counters = (tdk.dense_conv_fwd, tdk.dense_conv_dx, tdk.dense_conv_dk)
    before = [c.launches for c in counters]
    out = tdk.dense_conv_fwd(x, a, b, k)
    dx, da, db = tdk.dense_conv_dx(g, x, a, k)
    dk = tdk.dense_conv_dk(x, g, a, b)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    assert out.shape == (*shape[:3], cout) and dk.shape == (3, 3, shape[-1], cout)
    _close(out, tdc.conv3x3_nhwc_reference(x, a, b, k), dtype)
    rdx, rda, rdb = tdc.conv3x3_dx_plain(g, x, a, k)
    _close(dx, rdx, dtype)
    _close(da, rda, dtype, rtol=1e-3)
    _close(db, rdb, dtype, rtol=1e-3)
    _close(dk, tdc.conv3x3_dk_plain(x, g, a, b), dtype, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_conv_fwd_is_deterministic(card, dtype):
    """B7 at the regression step's 96x128 shape, batch 16: two runs, same
    bits."""
    x, a, b, k, _ = _dense_inputs((16, 96, 128, 48), 12, card, seed=6)
    dt = getattr(torch, dtype)
    x, k = x.to(dt), k.to(dt)
    assert torch.equal(tdk.dense_conv_fwd(x, a, b, k), tdk.dense_conv_fwd(x, a, b, k))


def test_dense_conv_reductions_are_deterministic(card):
    x, a, b, k, g = _dense_inputs((4, 48, 64, 48), 12, card)
    first = (*tdk.dense_conv_dx(g, x, a, k)[1:], tdk.dense_conv_dk(x, g, a, b))
    second = (*tdk.dense_conv_dx(g, x, a, k)[1:], tdk.dense_conv_dk(x, g, a, b))
    assert all(torch.equal(p, q) for p, q in zip(first, second))


# B8 where the dense layer's one block per (48-channel cin, 16-channel cout)
# does not cover the widths: several cin and cout blocks, ragged both ways
DK_RAGGED = [((2, 16, 40, 100), 20), ((2, 9, 33, 49), 17), ((1, 24, 64, 96), 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", DK_RAGGED)
def test_dense_dk_matches_plain_at_ragged_widths(card, dtype, shape, cout):
    x, a, b, _, g = _dense_inputs(shape, cout, card, seed=4)
    dt = getattr(torch, dtype)
    x, g = x.to(dt), g.to(dt)
    before = tdk.dense_conv_dk.launches
    dk = tdk.dense_conv_dk(x, g, a, b)
    torch.cuda.synchronize()
    assert tdk.dense_conv_dk.launches == before + 1
    _close(dk, tdc.conv3x3_dk_plain(x, g, a, b), dtype, rtol=1e-3)


# B7 on several input slabs and output passes: the ragged widths above and
# 144 -> 40 (three full 48-channel slabs, three passes of 16 output channels)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", DK_RAGGED + [((2, 16, 64, 144), 40)])
def test_dense_fwd_matches_plain_at_ragged_widths(card, dtype, shape, cout):
    x, a, b, k, _ = _dense_inputs(shape, cout, card, seed=7)
    dt = getattr(torch, dtype)
    x, k = x.to(dt), k.to(dt)
    before = tdk.dense_conv_fwd.launches
    out = tdk.dense_conv_fwd(x, a, b, k)
    torch.cuda.synchronize()
    assert tdk.dense_conv_fwd.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (*shape[:3], cout)
    _close(out, tdc.conv3x3_nhwc_reference(x, a, b, k), dtype)


def test_dense_dk_is_deterministic_at_the_path_shape(card):
    """B8 at the regression step's 96x128 shape, batch 16: 96 tiles of
    chunks summed in chunk order; two runs, same bits."""
    x, a, b, _, g = _dense_inputs((16, 96, 128, 48), 12, card, seed=5)
    assert tdk.dk_chunks(16 * 12 * 4, 48, 12)[1] > 1
    assert torch.equal(tdk.dense_conv_dk(x, g, a, b), tdk.dense_conv_dk(x, g, a, b))


def test_fused_affine_conv_backward_uses_the_kernels(card):
    """fused_affine_conv3x3 on the card: all four gradients against autograd
    of the plain forward, each kernel launched once."""
    x, a, b, k, g = _dense_inputs((2, 24, 40, 48), 12, card)
    x, a, b, k = (t.requires_grad_() for t in (x, a, b, k))
    counters = (tdk.dense_conv_fwd, tdk.dense_conv_dx, tdk.dense_conv_dk)
    before = [c.launches for c in counters]
    got = torch.autograd.grad((tdc.fused_affine_conv3x3(x, a, b, k) * g).sum(), (x, a, b, k))
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref = torch.autograd.grad((tdc.conv3x3_nhwc_reference(x, a, b, k) * g).sum(), (x, a, b, k))
    for p, q in zip(got, ref):
        torch.testing.assert_close(p, q, rtol=1e-3, atol=1e-4)


def test_dense_conv_wrappers_reject_what_the_kernels_do_not_take(card):
    x, a, b, k, g = _dense_inputs((1, 8, 16, 8), 4, card)
    with pytest.raises(TypeError):
        tdk.dense_conv_fwd(x, a, b, k.bfloat16())
    with pytest.raises(TypeError):
        tdk.dense_conv_fwd(x, a.double(), b, k)
    with pytest.raises(TypeError):
        tdk.dense_conv_dx(g.half(), x.half(), a, k.half())
    with pytest.raises(ValueError):
        tdk.dense_conv_dk(x.transpose(1, 2), g, a, b)
    with pytest.raises(ValueError):
        tdk.dense_conv_fwd(x, a[:4], b, k)
