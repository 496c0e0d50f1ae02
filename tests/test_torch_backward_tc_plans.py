"""What can be checked on the CPU of the tensor-core backward kernels B4
(sphere-conv dK, csrc/sphere_conv_dk.cu) and B3 (stride-1 dx,
csrc/sphere_conv_dx_s1.cu):

- their f32 arithmetic, emulated in NumPy around the port's plain versions,
  against the JAX package's Pallas kernels in interpret mode at the card's
  f32 bars (3xTF32 products, each operand split by cutting to TF32): B4
  over 16-pixel steps, each summed from zero and added in f32, over
  ``dk_plan``'s chunks summed in chunk order; B3 as
  the tap regrouping Σ_t Ĝ_t K_tᵀ, Ĝ_t summed over ``tap_grouped_tables``
  in slot order, over 16-deep K steps (64-byte Cout slabs x 9 taps,
  slab-major);
- the tap-grouped tables, which must hold exactly the slots of
  ``inverse_tables``;
- B4's grid (``dk_plan``) at every dK shape of the generator and the
  discriminator steps.

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import sphere_conv_vjp as jvjp
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from emlight_tpu_torch.nn import sphere_conv_vjp as tvjp
from test_torch_tensor_core_plans import generator_s1_shapes
from torch_port_helpers import matmul_3xtf32_cut

DK_RTOL, DK_ATOL = 1e-3, 1e-4  # the card's f32 bar for dK (chip_smoke.py phase 7)
DX_TOL = 1e-4                  # and for dx

# every map a sphere conv sees in the generator and the discriminator
G_RES = [(4, 8), (8, 16), (16, 32), (32, 64), (64, 128), (128, 256)]


# --- B4: dk_plain's arithmetic with the kernel's products and sums ------------

def dk_emulated(x, g, stride):
    """nn/sphere_conv_vjp.py::dk_plain in NumPy f32 as B4 sums it: S formed
    in the plain version's order, then per ``dk_plan`` chunk the 16-pixel
    steps' 3xTF32 products, each step from zero, added in f32; the chunks
    added in chunk order."""
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    idx, wgt, (ho, wo) = tsc.sphere_taps(h, w, stride)
    xf = x.reshape(b, h * w, cin)
    s = np.zeros((b, ho * wo, 9, cin), np.float32)
    for t in range(9):
        st = np.zeros((b, ho * wo, cin), np.float32)
        for k in range(4):
            st = st + xf[:, idx[:, t, k]] * wgt[:, t, k][None, :, None]
        s[:, :, t] = st
    a = s.reshape(-1, 9 * cin)
    gf = g.reshape(-1, cout)
    n_pix = a.shape[0]
    plan = tker.dk_plan(n_pix, cin, cout)
    dk = None
    for z in range(plan.n_chunks):
        part = np.zeros((9 * cin, cout), np.float32)
        for q0 in range(z * plan.chunk, min((z + 1) * plan.chunk, n_pix), plan.slab):
            q1 = min(q0 + plan.slab, n_pix)
            part = part + matmul_3xtf32_cut(a[q0:q1].T, gf[q0:q1])
        dk = part if dk is None else dk + part
    return dk.reshape(3, 3, cin, cout)


def _inputs(shape, cout, stride, seed):
    rng = np.random.default_rng(seed)
    b, h, w, cin = shape
    x = rng.random(shape, dtype=np.float32)
    k = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    g = rng.standard_normal((b, h // stride, w // stride, cout)).astype(np.float32)
    return x, k, g


# strides 1 and 2; cin 3 (all 9 taps in one row tile) and 6 (the
# discriminator's front), cout 3 (one 32-channel block); pixel counts off the
# 16-pixel step, and enough pixels to be cut into chunks
DK_CASES = [((2, 16, 32, 8), 8, 1), ((1, 16, 32, 3), 24, 1), ((2, 8, 16, 16), 3, 1),
            ((2, 16, 32, 6), 8, 2), ((1, 16, 32, 8), 3, 2), ((3, 4, 8, 5), 7, 1)]


@pytest.mark.parametrize("shape,cout,stride", DK_CASES)
def test_b4_emulation_matches_jax_pallas(shape, cout, stride):
    x, _, g = _inputs(shape, cout, stride, seed=21)
    b, h, w, cin = shape
    plan = tker.dk_plan(b * (h // stride) * (w // stride), cin, cout)
    assert plan.tiles_m == -(-9 * cin // 64)
    out = dk_emulated(x, g, stride)
    ref = np.asarray(jvjp._dk_pallas(jnp.asarray(x), jnp.asarray(g), stride, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=DK_RTOL, atol=DK_ATOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tvjp.dk_plain(torch.from_numpy(x), torch.from_numpy(g), stride).numpy()
    np.testing.assert_allclose(out, plain, rtol=DK_RTOL, atol=DK_ATOL)


def test_b4_emulation_splits_the_pixels():
    """The chunked case of DK_CASES really is cut, so its chunk-order sum is
    what the test above holds to the JAX kernel."""
    assert tker.dk_plan(2 * 16 * 32, 8, 8).n_chunks > 1
    assert tker.dk_plan(2 * 8 * 16, 16, 3).n_chunks > 1


# --- B3: the tap regrouping with the kernel's products and sums --------------

def dx_emulated(g, k, x_shape):
    """dx as B3 sums it: Ĝ_t[r, col] = Σ over the slots of (r, t) in slot
    order of w * g[out_row, (col - shift) mod W] (the dead column skipped),
    then Σ over the K steps (64-byte Cout slabs x 9 taps, slab-major: 16
    K values a step, 8 where the block is 256 channels wide) of Ĝ_t K_tᵀ in
    3xTF32, each step from zero, added in f32."""
    b, h, w, cout = g.shape
    cin = x_shape[-1]
    counts, orow, shifts, w0, jdev, _ = tvjp.tap_grouped_tables(h, w)
    cols = np.arange(w)
    gt = np.zeros((b, h, w, 9, cout), np.float32)
    for r in range(h):
        for t in range(9):
            acc = np.zeros((b, w, cout), np.float32)
            for m in range(counts[r, t]):
                j = (cols - shifts[r, t, m]) % w
                term = g[:, orow[r, t, m]][:, j] * w0[r, t, m]
                acc = np.where((j != jdev[r, t, m])[None, :, None], acc + term, acc)
            gt[:, r, :, t] = acc
    a = gt.reshape(-1, 9, cout)
    kt = k.reshape(9, cin, cout)
    dx = np.zeros((a.shape[0], cin), np.float32)
    depth = 16 if tker.tc_width(cin) <= 128 else 8
    for cs in range(0, cout, 16):
        for t in range(9):
            for o0 in range(cs, min(cs + 16, cout), depth):
                o = slice(o0, min(o0 + depth, cout))
                dx = dx + matmul_3xtf32_cut(a[:, t, o], kt[t][:, o].T)
    return dx.reshape(x_shape)


# whole maps, with the rows by the poles where the fan-in is largest; cin 3, cout 3
# (a K of 27 in one slab), cout 24 (two slabs, the second ragged), and the
# 2048-pixel map (B3's arithmetic; the card's routing gives this map to B6)
DX_CASES = [((2, 8, 16, 8), 8), ((1, 16, 32, 3), 8), ((2, 16, 32, 16), 3),
            ((1, 8, 16, 5), 24), ((1, 32, 64, 4), 3)]


@pytest.mark.parametrize("shape,cout", DX_CASES)
def test_b3_regrouping_matches_jax_pallas(shape, cout):
    x, k, g = _inputs(shape, cout, 1, seed=22)
    # the whole map: its rows by the poles, where the fan-in is largest
    counts = tvjp.tap_grouped_tables(shape[1], shape[2])[0]
    assert counts.sum(1).max() == tvjp.inverse_tables(shape[1], shape[2], 1)[-1]
    out = dx_emulated(g, k, shape)
    ref = np.asarray(jvjp._dx_pallas(jnp.asarray(g), jnp.asarray(k), shape, 1, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=DX_TOL, atol=DX_TOL)
    plain = tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), shape, 1).numpy()
    np.testing.assert_allclose(out, plain, rtol=DX_TOL, atol=DX_TOL)


# --- the tap-grouped tables ----------------------------------------------------

@pytest.mark.parametrize("h,w", G_RES + [(5, 7), (6, 10)])
def test_tap_grouped_tables_hold_the_slots_of_inverse_tables(h, w):
    counts, orow, shifts, w0, jdev, smax = tvjp.tap_grouped_tables(h, w)
    o2, t2, s2, w2, j2, fanin = jvjp.inverse_tables(h, w, 1)
    assert smax == max(1, counts.max())
    for r in range(h):
        for t in range(9):
            want = [(o2[r, m], s2[r, m], w2[r, m], j2[r, m]) for m in range(fanin)
                    if w2[r, m] != 0 and t2[r, m] == t]
            n = counts[r, t]
            got = [(orow[r, t, m], shifts[r, t, m], w0[r, t, m], jdev[r, t, m]) for m in range(n)]
            assert got == want, (r, t)
            # past the count: weight 0, no dead column, the row's own output row
            assert (w0[r, t, n:] == 0).all() and (jdev[r, t, n:] == -1).all()
            assert (orow[r, t, n:] == r).all()
    # every live slot of a row once
    assert counts.sum() == (w2 != 0).sum()


@pytest.mark.parametrize("h,w", G_RES)
def test_tap_grouped_tables_stay_in_the_inverse_halo(h, w):
    """At the model's maps a tap has at most 8 slots and their output rows
    lie in [r - 1, r + 2], the JAX kernel's inverse halo: the rows B3 stages."""
    counts, orow, *_, smax = tvjp.tap_grouped_tables(h, w)
    assert smax <= 8
    live = np.arange(smax)[None, None, :] < counts[..., None]
    d = (orow - np.arange(h)[:, None, None])[live]
    assert d.min() >= -1 and d.max() <= 2
    _, _, _, dmin, dmax = tker._device_tap_tables(h, w, "cpu")
    assert (dmin, dmax) == (int(min(0, d.min())), int(max(0, d.max())))


# --- B4's grid -------------------------------------------------------------------

# (B, H, W, Cin, Cout, stride) of every dK the training path launches: the
# generator's 44 stride-1 convs at batch 8 (G step), the discriminator's
# trainable convs at batch 16 (D step: fake and real), and ragged ones
D_DK_SHAPES = [(16, 8, 16, 256, 512, 1), (16, 8, 16, 512, 3, 1), (16, 16, 32, 128, 256, 2),
               (16, 16, 32, 256, 512, 1), (16, 16, 32, 512, 3, 1), (16, 32, 64, 64, 128, 2),
               (16, 32, 64, 128, 256, 2), (16, 64, 128, 6, 64, 2), (16, 64, 128, 64, 128, 2),
               (16, 128, 256, 6, 64, 2)]
DK_PLAN_SHAPES = ([(8, h, w, cin, cout, 1) for h, w, cin, cout in sorted(set(generator_s1_shapes()))]
                  + D_DK_SHAPES + [(1, 1, 1, 1, 1, 1), (3, 5, 7, 20, 70, 1), (2, 6, 10, 9, 5, 2)])


@pytest.mark.parametrize("shape", DK_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dk_plan_covers_every_pixel_and_tile_once(shape):
    b, h, w, cin, cout, stride = shape
    n_pix = b * (h // stride) * (w // stride)
    plan = tker.dk_plan(n_pix, cin, cout)
    assert plan.bm == 64 and plan.slab == 16 and plan.bn in (32, 64, 128, 256)
    # the kernel's decode of blockIdx.x (n tile fastest) visits each tile once
    tiles = sorted((bid // plan.tiles_n, bid % plan.tiles_n)
                   for bid in range(plan.tiles_m * plan.tiles_n))
    assert tiles == [(mt, nt) for mt in range(plan.tiles_m) for nt in range(plan.tiles_n)]
    rows = np.zeros(9 * cin, int)
    for mt in range(plan.tiles_m):
        rows[mt * plan.bm:(mt + 1) * plan.bm] += 1
    assert (rows == 1).all() and (plan.tiles_m - 1) * plan.bm < 9 * cin
    chans = np.zeros(cout, int)
    for nt in range(plan.tiles_n):
        chans[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (chans == 1).all() and (plan.tiles_n - 1) * plan.bn < cout
    # every pixel in exactly one chunk, each chunk whole slabs and non-empty
    assert plan.chunk % plan.slab == 0
    pix = np.zeros(n_pix, int)
    for z in range(plan.n_chunks):
        lo, hi = z * plan.chunk, min((z + 1) * plan.chunk, n_pix)
        assert hi > lo
        pix[lo:hi] += 1
    assert (pix == 1).all()
    # the chunks' partials stay within 64 MiB
    if plan.n_chunks > 1:
        assert plan.n_chunks * 9 * cin * cout * 4 <= 64 << 20
    if cin <= 7:
        assert plan.tiles_m == 1  # all 9 taps in one row tile


def test_dk_plan_fills_the_card_where_the_pixels_allow():
    """Every dK of the training path with work for 4 blocks per SM (tiles
    times 16-pixel slabs) keeps the 132 SMs (one block each) at least seven
    tenths busy over its rounds of blocks, whether its tiles are few (the
    128x256 convs: the pixels are cut into chunks) or many but not a
    multiple of 132 (the wide 8x16 and 16x32 convs)."""
    checked = 0
    for shape in DK_PLAN_SHAPES[:-3]:
        b, h, w, cin, cout, stride = shape
        n_pix = b * (h // stride) * (w // stride)
        plan = tker.dk_plan(n_pix, cin, cout)
        if plan.tiles_m * plan.tiles_n * -(-n_pix // plan.slab) < 4 * 132:
            continue
        blocks = plan.tiles_m * plan.tiles_n * plan.n_chunks
        assert blocks / (132 * -(-blocks // 132)) >= 0.7, (shape, plan)
        checked += 1
    assert checked >= 30


@pytest.mark.parametrize("n,bn", [(3, 32), (64, 64), (128, 128), (256, 256), (384, 128),
                                  (512, 256), (2048, 256), (70, 32), (20, 32)])
def test_tc_width_pads_least(n, bn):
    assert tker.tc_width(n) == bn
