"""What can be checked on the CPU of the tensor-core kernels B1 (stride-1
sphere conv, csrc/sphere_conv_s1.cu) and B7′ (the dense layer's dx,
csrc/dense_conv.cu):

- their f32 arithmetic, 3xTF32 products (v = hi + lo, each rounded to TF32,
  hi*hi + hi*lo + lo*hi summed in f32), emulated in NumPy around the port's
  plain versions, against the JAX package (the Pallas sphere conv and the VJP
  of the fused dense conv, both in interpret mode) at the card's f32 bars;
  a single TF32 pass fails the same bar, so the bar tells the two apart;
- B1's tile and K-split plan (``s1_plan``) at every stride-1 shape of the
  generator and the discriminator, and B7′'s persistent grid (``dx_blocks``).

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import dense_conv_pallas as jdc
from emlight_tpu.nn import sphere_conv_pallas as jpal
from emlight_tpu_torch.nn import dense_conv_kernel as tdk
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from torch_port_helpers import matmul_1xtf32, matmul_3xtf32, tf32

RTOL = ATOL = 1e-4  # the card's f32 bar for B1 and B7′'s dx (chip_smoke.py)
SUM_RTOL = 1e-3     # da, db: long sums over pixels


def test_tf32_rounding():
    bits = np.array([0x3F800000, 0x3F801000, 0x3F803000, 0x3F800FFF, 0xBF801001],
                    np.uint32).view(np.float32)
    want = np.array([0x3F800000, 0x3F800000, 0x3F804000, 0x3F800000, 0xBF802000],
                    np.uint32).view(np.float32)
    np.testing.assert_array_equal(tf32(bits), want)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = tf32(x)
    # hi + lo keeps about 22 of the 24 bits
    assert (np.abs(hi + tf32(x - hi) - x) <= 2.0 ** -21 * np.abs(x)).all()


# --- B1: the plain version's arithmetic with emulated products ----------------

def sphere_conv_emulated(x, k, bias, matmul):
    """nn/sphere_conv.py::sphere_conv_plain in NumPy f32, its per-tap
    product taken by `matmul`."""
    b, h, w, cin = x.shape
    idx, wgt, _ = tsc.sphere_taps(h, w, 1)
    xf = x.reshape(b, h * w, cin)
    out = np.zeros((b, h * w, k.shape[-1]), np.float32)
    kf = k.reshape(9, cin, -1)
    for t in range(9):
        s = np.zeros((b, h * w, cin), np.float32)
        for q in range(4):
            s = s + xf[:, idx[:, t, q]] * wgt[:, t, q][None, :, None]
        out = out + matmul(s.reshape(-1, cin), kf[t]).reshape(b, h * w, -1)
    return (out + bias).reshape(b, h, w, -1)


def _sphere_inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.normal(0, 0.2, (3, 3, shape[-1], cout)).astype(np.float32),
            rng.normal(0, 0.1, cout).astype(np.float32))


def _sphere_jax(x, k, bias):
    return np.asarray(jpal.sphere_conv_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                              1, block_rows=8, interpret=True))


SPHERE_SHAPES = [((2, 8, 16, 128), 16), ((1, 16, 32, 16), 8)]


@pytest.mark.parametrize("shape,cout", SPHERE_SHAPES)
def test_b1_3xtf32_matches_jax_pallas(shape, cout):
    x, k, bias = _sphere_inputs(shape, cout, seed=11)
    out = sphere_conv_emulated(x, k, bias, matmul_3xtf32)
    np.testing.assert_allclose(out, _sphere_jax(x, k, bias), rtol=RTOL, atol=ATOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tsc.sphere_conv_plain(torch.from_numpy(x), torch.from_numpy(k),
                                  torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(out, plain, rtol=RTOL, atol=ATOL)


def test_b1_single_tf32_pass_fails_the_bar():
    shape, cout = SPHERE_SHAPES[0]
    x, k, bias = _sphere_inputs(shape, cout, seed=11)
    out = sphere_conv_emulated(x, k, bias, matmul_1xtf32)
    ref = _sphere_jax(x, k, bias)
    assert not np.allclose(out, ref, rtol=RTOL, atol=ATOL)


# --- B7′: conv3x3_dx_plain's arithmetic with emulated products ---------------

def dense_dx_emulated(g, x, a, k, matmul):
    """nn/dense_conv.py::conv3x3_dx_plain in NumPy f32, each tap's
    g[q - off_t] K_tᵀ taken by `matmul`: (dx, da, db)."""
    b, h, w, cout = g.shape
    gp = np.pad(g, ((0, 0), (1, 1), (1, 1), (0, 0)))
    dy2 = np.zeros((b, h, w, k.shape[2]), np.float32)
    for ky in range(3):
        for kx in range(3):
            gs = gp[:, 2 - ky:2 - ky + h, 2 - kx:2 - kx + w].reshape(-1, cout)
            dy2 = dy2 + matmul(gs, k[ky, kx].T).reshape(dy2.shape)
    return dy2 * a, (dy2 * x).sum((0, 1, 2)), dy2.sum((0, 1, 2))


def _dense_inputs(b, h, w, c, o, seed):
    rng = np.random.default_rng(seed)
    return [v.astype(np.float32) for v in (
        rng.standard_normal((b, h, w, c)), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c),
        rng.standard_normal((3, 3, c, o)), rng.standard_normal((b, h, w, o)))]


def _dense_jax_dx(x, a, b, k, g):
    """(dx, da, db): the VJP of JAX's fused Pallas conv (interpret mode)."""
    _, vjp = jax.vjp(lambda x_, a_, b_: jdc.fused_affine_conv3x3(x_, a_, b_, jnp.asarray(k), True),
                     jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


# the dense layer's widths (48 <- 12) and tests/test_densenet_fast.py's 5 <- 3,
# both at shapes JAX's kernels support
DENSE_SHAPES = [(2, 16, 32, 48, 12), (2, 16, 24, 5, 3)]


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_b7_dx_3xtf32_matches_jax_pallas_vjp(shape):
    assert jdc.supported(shape[1], shape[2])
    x, a, b, k, g = _dense_inputs(*shape, seed=12)
    got = dense_dx_emulated(g, x, a, k, matmul_3xtf32)
    ref = _dense_jax_dx(x, a, b, k, g)
    for name, out, r, rtol in zip(("dx", "da", "db"), got, ref, (RTOL, SUM_RTOL, SUM_RTOL)):
        np.testing.assert_allclose(out, r, rtol=rtol, atol=ATOL, err_msg=name)


def test_b7_dx_single_tf32_pass_fails_the_bar():
    x, a, b, k, g = _dense_inputs(*DENSE_SHAPES[0], seed=12)
    dx, _, _ = dense_dx_emulated(g, x, a, k, matmul_1xtf32)
    ref = _dense_jax_dx(x, a, b, k, g)[0]
    assert not np.allclose(dx, ref, rtol=RTOL, atol=ATOL)


# --- B1's plan -----------------------------------------------------------------

def generator_s1_shapes(ngf=64, sh=4, sw=8):
    """(H, W, Cin, Cout) of every stride-1 sphere conv of one SPADEGenerator
    forward (nn/spade.py, num_upsampling_layers 'normal', nhidden 128,
    label_nc 3): per block mlp_shared 3 -> 128 * n_norms, one mlp_gammabeta
    128 -> 2C per SPADE, conv_0, conv_1 and the learned shortcut conv_s; then
    sphere_conv1 ngf -> 3."""
    nf = ngf
    blocks = [(16 * nf, 16 * nf, 1), (16 * nf, 16 * nf, 2), (16 * nf, 16 * nf, 2),
              (16 * nf, 8 * nf, 4), (8 * nf, 4 * nf, 8), (4 * nf, 2 * nf, 16),
              (2 * nf, nf, 32)]  # (fin, fout, map scale over (sh, sw))
    convs = []
    for fin, fout, scale in blocks:
        h, w = sh * scale, sw * scale
        mid = min(fin, fout)
        shortcut = fin != fout
        convs.append((h, w, 3, 128 * (3 if shortcut else 2)))
        convs += [(h, w, 128, 2 * fin), (h, w, 128, 2 * mid)]
        if shortcut:
            convs.append((h, w, 128, 2 * fin))
        convs += [(h, w, fin, mid), (h, w, mid, fout)]
        if shortcut:
            convs.append((h, w, fin, fout))
    convs.append((sh * 32, sw * 32, nf, 3))
    return convs


def test_generator_shapes_are_the_main_paths():
    convs = generator_s1_shapes()
    assert len(convs) == 44 and len(set(convs)) == 27  # chip_smoke.py's counts
    assert min(convs) == (4, 8, 3, 256) and (128, 256, 64, 3) in convs


# every stride-1 shape B1 runs: the generator's 27 at the serving and G-step
# batch 8; the discriminator's stride-1 convs (ndf 64, n_layers 4, num_d 2)
# at batch 16 (D reads fake and real); ragged maps whose tiles cross rows
# and images
PLAN_SHAPES = ([(8, *s) for s in sorted(set(generator_s1_shapes()))]
               + [(16, 16, 32, 256, 512), (16, 16, 32, 512, 3), (16, 8, 16, 256, 512),
                  (16, 8, 16, 512, 3)]
               + [(3, 5, 7, 20, 70), (1, 5, 1, 17, 9)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_s1_plan_covers_every_tile_and_k_range_once(shape, dtype):
    b, h, w, cin, cout = shape
    plan = tker.s1_plan(*shape, dtype)
    assert plan.bk * dtype.itemsize == 64  # a K step is 64 bytes of a pixel
    m = b * h * w
    # the kernel's decode of blockIdx.x (n tile fastest) visits each
    # (m tile, n tile) once per split, and the tiles cover the output once
    bids = range(plan.tiles_m * plan.tiles_n)
    assert sorted((bid // plan.tiles_n, bid % plan.tiles_n) for bid in bids) == [
        (mt, nt) for mt in range(plan.tiles_m) for nt in range(plan.tiles_n)]
    pix = np.zeros(m, int)
    for mt in range(plan.tiles_m):
        pix[mt * plan.bm:(mt + 1) * plan.bm] += 1
    assert (pix == 1).all() and (plan.tiles_m - 1) * plan.bm < m
    chans = np.zeros(cout, int)
    for nt in range(plan.tiles_n):
        chans[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (chans == 1).all() and (plan.tiles_n - 1) * plan.bn < cout
    # every (tap, cin) of K in exactly one split, and no split empty
    k_cover = np.zeros((9, cin), int)
    for split in range(plan.n_split):
        # the kernel's split: steps [split * per, (split + 1) * per) of n_steps
        steps = range(split * plan.per, min(plan.n_steps, (split + 1) * plan.per))
        assert len(steps) > 0
        for s in steps:
            slab, tap = divmod(s, 9)
            k_cover[tap, slab * plan.bk:(slab + 1) * plan.bk] += 1
    assert (k_cover == 1).all()
    assert plan.n_steps == 9 * -(-cin // plan.bk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [s for s in PLAN_SHAPES
                                   if s[1] * s[2] < 2048 and s[3] * s[4] >= 1 << 17],
                         ids=lambda s: "x".join(map(str, s)))
def test_s1_plan_fills_the_card_on_small_maps(shape, dtype):
    """The 4x8, 8x16 and 16x32 convs with cin * cout >= 2**17 get at least
    one block per SM of an H100's 132, by splitting K where the output tiles
    alone give fewer than 2 x 132 blocks."""
    plan = tker.s1_plan(*shape, dtype)
    assert plan.tiles_m * plan.tiles_n * plan.n_split >= 132
    assert (plan.n_split > 1) == (plan.tiles_m * plan.tiles_n < 264)


def test_s1_plan_keeps_large_maps_whole():
    """The 64x128 and 128x256 maps have thousands of output tiles: no split,
    no partials."""
    for shape in PLAN_SHAPES:
        if shape[1] * shape[2] >= 8192:
            for dtype in (torch.float32, torch.bfloat16):
                assert tker.s1_plan(*shape, dtype).n_split == 1, shape


@pytest.mark.parametrize("b,h,w", [(16, 192, 256), (16, 96, 128), (16, 48, 64), (2, 8, 16),
                                   (1, 1, 1), (3, 13, 37)])
def test_dx_blocks_walk_every_tile_once(b, h, w):
    """B7′'s persistent grid: block j takes tiles j, j + n_blocks, ...; every
    tile once, every block at least one tile (each writes a dA/dB partial)."""
    n_tiles = b * -(-h // 8) * -(-w // 32)
    n_blocks = tdk.dx_blocks(b, h, w)
    assert 1 <= n_blocks <= min(132, n_tiles)
    seen = sorted(t for j in range(n_blocks) for t in range(j, n_tiles, n_blocks))
    assert seen == list(range(n_tiles))
