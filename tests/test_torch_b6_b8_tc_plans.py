"""What can be checked on the CPU of the tensor-core kernels B6 (stride-1
sphere-conv dx on the small maps, csrc/sphere_conv_dx_triple.cu) and B8
(the dense layer's dK, csrc/dense_conv.cu ``dk_kernel``):

- their f32 arithmetic, emulated in NumPy, against the JAX package's Pallas
  kernels in interpret mode at the card's f32 bars. Both take 3xTF32
  products with each operand split by cutting to TF32, each 16-deep step
  summed from zero and added in f32:
  - B6 as its GEMM forms U = g K_tᵀ (16-channel steps of Cout within
    ``triple_tiles``' K splits, the splits' partials added in split order),
    then the gather over ``inverse_tables`` in slot order, against
    ``_dx_pallas`` (``_dx_kernel_s1`` on these maps);
  - B8 as its implicit GEMM sums dK[t] = Σ_p y[p + off_t]ᵀ g[p]: per 8x32
    tile in 16-pixel steps, the top four rows' steps and the bottom four's
    in two sums over the tiles of a ``dk_chunks`` chunk in order, added top
    then bottom, the chunks added in chunk order, against ``_dk_pallas``;
- their plans: every pixel, row of N and Cout channel of B6's GEMM in one
  tile and one K split, enough blocks for the card at every small-map
  shape of the training path; every 8x32 tile of B8 in exactly one chunk.

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import dense_conv_pallas as jdc
from emlight_tpu.nn import sphere_conv_vjp as jvjp
from emlight_tpu_torch.nn import dense_conv as tdc
from emlight_tpu_torch.nn import dense_conv_kernel as tdk
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from emlight_tpu_torch.nn import sphere_conv_vjp as tvjp
from test_torch_tensor_core_plans import generator_s1_shapes
from torch_port_helpers import matmul_3xtf32_cut

DX_TOL = 1e-4                  # the card's f32 bar for dx (chip_smoke.py phase 7)
DK_RTOL, DK_ATOL = 1e-3, 1e-4  # and for the dense layer's dK (phase 11)
SMS = 132                      # an H100's SMs


# --- B6: U by the GEMM's steps and splits, then the slot-ordered gather ------

def b6_emulated(g, k, x_shape):
    """dx as B6 sums it: U[p, (t, c)] = Σ over ``triple_tiles``' K splits,
    in split order, of the split's 16-channel steps of g[p] K_t[c]ᵀ in
    3xTF32, each step from zero, added in f32; then per input row r and
    live slot m of ``inverse_tables`` in slot order, dx[r, col] +=
    w0 * U[(out_row, (col - shift) mod W), tap] except at the dead column."""
    b, h, w, cout = g.shape
    cin = x_shape[-1]
    plan = tker.triple_tiles(b, h, w, cin, cout)
    gf = g.reshape(-1, cout)
    kf = k.reshape(9, cin, cout).reshape(9 * cin, cout)
    u = None
    for z in range(plan.n_split):
        part = np.zeros((gf.shape[0], 9 * cin), np.float32)
        for o0 in range(z * plan.per, min(cout, (z + 1) * plan.per), 16):
            o = slice(o0, min(o0 + 16, cout))
            part = part + matmul_3xtf32_cut(gf[:, o], kf[:, o].T)
        u = part if u is None else u + part
    u = u.reshape(b, h, w, 9, cin)
    orow, taps, shifts, w0, jdev, fanin = tvjp.inverse_tables(h, w, 1)
    cols = np.arange(w)
    dx = np.zeros((b, h, w, cin), np.float32)
    for r in range(h):
        acc = np.zeros((b, w, cin), np.float32)
        for m in range(fanin):
            if w0[r, m] == 0:
                continue
            j = (cols - shifts[r, m]) % w
            term = u[:, orow[r, m], j, taps[r, m]] * w0[r, m]
            acc = np.where((j != jdev[r, m])[None, :, None], acc + term, acc)
        dx[:, r] = acc
    return dx


def _sphere_inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    k = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    g = rng.standard_normal((*shape[:3], cout)).astype(np.float32)
    return k, g


# maps below 2048 pixels, where _dx_pallas takes _dx_kernel_s1; cin and cout
# off the 128-row and 32-channel tiles, cout 3 (one ragged step), a K cut
# into splits (cout 70 on one tile: 3 splits of 32), W off the 64-pixel tile
B6_CASES = [((2, 8, 16, 8), 8), ((1, 4, 8, 5), 70), ((2, 8, 16, 16), 3), ((1, 6, 10, 9), 5),
            ((2, 16, 32, 4), 20), ((3, 4, 8, 24), 40)]


@pytest.mark.parametrize("shape,cout", B6_CASES)
def test_b6_gemm_and_gather_match_jax_pallas(shape, cout):
    k, g = _sphere_inputs(shape, cout, seed=31)
    assert shape[1] * shape[2] < jvjp._UMAJOR_MIN_PIXELS  # JAX's per-triple kernel
    out = b6_emulated(g, k, shape)
    ref = np.asarray(jvjp._dx_pallas(jnp.asarray(g), jnp.asarray(k), shape, 1, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=DX_TOL, atol=DX_TOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), shape, 1).numpy()
    np.testing.assert_allclose(out, plain, rtol=DX_TOL, atol=DX_TOL)


def test_b6_emulation_cuts_k():
    """The split case of B6_CASES really is cut, so its split-order sum is
    what the test above holds to the JAX kernel."""
    assert tker.triple_tiles(1, 4, 8, 5, 70).n_split == 3
    assert tker.triple_tiles(3, 4, 8, 24, 40).n_split == 2


def test_b6_skips_padded_slots_and_the_dead_column():
    """An inf in g reaches dx only through live slots off the dead column:
    wherever the plain version is finite, the emulation is too."""
    shape, cout = (1, 8, 16, 8), 8
    k, g = _sphere_inputs(shape, cout, seed=32)
    g[0, 3, 5, 2] = np.inf
    with np.errstate(invalid="ignore", over="ignore"):
        out = b6_emulated(g, k, shape)
    plain = tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), shape, 1).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(plain))
    assert not np.isfinite(plain).all() and np.isfinite(plain).any()


# (B, H, W, Cin, Cout) of every stride-1 dx the routing gives B6 on the
# training path (the maps below UMAJOR_MIN_PIXELS, 4x8 to 64x128): the
# generator's at the G step's batch 8 (the mlp_shared convs read the
# constant guide: no dx), the discriminator's at its batch 16; and the check
# batch 2 of chip_smoke.py
B6_PATH_SHAPES = sorted(
    {(bb, h, w, cin, cout) for h, w, cin, cout in generator_s1_shapes()
     if h * w < tker.UMAJOR_MIN_PIXELS and cin != 3 for bb in (2, 8)}
    | {(bb, h, w, cin, cout) for h, w, cin, cout in [(8, 16, 256, 512), (8, 16, 512, 3),
                                                     (16, 32, 256, 512), (16, 32, 512, 3)]
       for bb in (2, 8, 16)})
B6_PLAN_SHAPES = B6_PATH_SHAPES + [(3, 5, 7, 20, 70), (1, 6, 10, 9, 5), (1, 1, 1, 1, 1),
                                   (2, 4, 8, 3, 3), (1, 8, 12, 130, 33)]


@pytest.mark.parametrize("shape", B6_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_triple_tiles_cover_every_pixel_row_and_k_range_once(shape):
    b, h, w, cin, cout = shape
    plan = tker.triple_tiles(*shape)
    assert (plan.bm, plan.bn, plan.bk) == (64, 128, 32)
    p, n = b * h * w, 9 * cin
    pix = np.zeros(p, int)
    for mt in range(plan.tiles_m):
        pix[mt * plan.bm:(mt + 1) * plan.bm] += 1
    assert (pix == 1).all() and (plan.tiles_m - 1) * plan.bm < p
    rows = np.zeros(n, int)
    for nt in range(plan.tiles_n):
        rows[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (rows == 1).all() and (plan.tiles_n - 1) * plan.bn < n
    # the kernel's split z sums Cout channels [z per, (z + 1) per): whole
    # stages, every channel once, no split empty
    assert plan.per % plan.bk == 0
    chans = np.zeros(cout, int)
    for z in range(plan.n_split):
        lo, hi = z * plan.per, min(cout, (z + 1) * plan.per)
        assert hi > lo
        chans[lo:hi] += 1
    assert (chans == 1).all()


@pytest.mark.parametrize("shape", B6_PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_triple_tiles_fill_the_card_on_the_small_maps(shape):
    """Every dx of the training path that B6 takes gets about 2 blocks per SM
    of an H100's 132: from the output tiles where they are enough, else by
    cutting K, as far as Cout's 32-channel stages allow."""
    b, h, w, cin, cout = shape
    plan = tker.triple_tiles(*shape)
    tiles = plan.tiles_m * plan.tiles_n
    assert (plan.n_split > 1) == (tiles < 2 * SMS and cout > plan.bk)
    stages = -(-cout // plan.bk)
    assert tiles * plan.n_split >= min(2 * SMS, tiles * stages)
    if b >= 8:
        assert tiles * plan.n_split >= SMS


def test_b6_path_shapes_are_the_launch_counts():
    """The G step's 34 stride-1 dx launches below the gate at batch 8: 30
    in the generator (18 on the 4x8 to 16x32 maps, 12 on 32x64 and 64x128),
    4 in the discriminator (chip_smoke.py)."""
    gen = [s for s in generator_s1_shapes() if s[0] * s[1] < tker.UMAJOR_MIN_PIXELS and s[2] != 3]
    assert len(gen) == 30 and sum(s[0] * s[1] < 2048 for s in gen) == 18
    assert {(8, *s) for s in gen} <= set(B6_PATH_SHAPES)


# --- B8: the implicit GEMM's steps, tiles and chunks ------------------------

def b8_emulated(x, g, a, b):
    """dK as B8 sums it: y = x * a + b (one rounding to f32) and 0 outside
    the image; per 8x32 tile and 16-pixel step (a half tile row), for each
    tap, y[p + off_t]ᵀ g[p] in 3xTF32 from zero, added in f32 to the sum of
    the tile's top four rows or of its bottom four (two warps per tap), the
    tiles of a ``dk_chunks`` chunk in order; the chunk's partial is top +
    bottom, the chunks added in chunk order."""
    bsz, h, w, cin = x.shape
    cout = g.shape[-1]
    y = (x.astype(np.float64) * a + b).astype(np.float32)
    yp = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)))
    nty, ntx = -(-h // 8), -(-w // 32)
    n_tiles = bsz * nty * ntx
    per, n_chunks = tdk.dk_chunks(n_tiles, cin, cout)
    dk = np.zeros((9, cin, cout), np.float32)
    for z in range(n_chunks):
        part = np.zeros((2, 9, cin, cout), np.float32)
        for tile in range(z * per, min(n_tiles, (z + 1) * per)):
            bi, rem = divmod(tile, nty * ntx)
            r0, c0 = (rem // ntx) * 8, (rem % ntx) * 32
            for s in range(16):
                r = r0 + s // 2
                cs = slice(c0 + (s % 2) * 16, min(w, c0 + (s % 2) * 16 + 16))
                if r >= h or cs.start >= w:
                    continue
                gs = g[bi, r, cs]
                for t in range(9):
                    ky, kx = divmod(t, 3)
                    ys = yp[bi, r + ky, cs.start + kx:cs.stop + kx]
                    part[s // 8, t] = part[s // 8, t] + matmul_3xtf32_cut(ys.T, gs)
        dk = dk + (part[0] + part[1])
    return dk.reshape(3, 3, cin, cout)


def _dense_inputs(b, h, w, c, o, seed):
    rng = np.random.default_rng(seed)
    return [v.astype(np.float32) for v in (
        rng.standard_normal((b, h, w, c)), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c),
        rng.standard_normal((b, h, w, o)) / np.sqrt(b * h * w))]


# the dense layer's widths (48 <- 12) on one and several tiles per image, W
# off the 32-column tile, narrow widths (5 <- 3, 20 <- 7), and a map with
# more tiles than SMs, so chunks hold several tiles
B8_CASES = [(2, 16, 32, 48, 12), (2, 16, 40, 48, 12), (1, 16, 24, 5, 3), (2, 24, 16, 20, 7),
            (1, 96, 512, 4, 3)]


@pytest.mark.parametrize("shape", B8_CASES, ids=lambda s: "x".join(map(str, s)))
def test_b8_implicit_gemm_matches_jax_pallas(shape):
    bsz, h, w, cin, cout = shape
    assert jdc.supported(h, w)
    x, a, b, g = _dense_inputs(*shape, seed=33)
    out = b8_emulated(x, g, a, b)
    ref = np.asarray(jdc._dk_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(a),
                                    jnp.asarray(b), interpret=True))[:, :cin]
    np.testing.assert_allclose(out.reshape(9, cin, cout), ref, rtol=DK_RTOL, atol=DK_ATOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tdc.conv3x3_dk_plain(*(torch.from_numpy(v) for v in (x, g, a, b))).numpy()
    np.testing.assert_allclose(out, plain, rtol=DK_RTOL, atol=DK_ATOL)


def test_b8_emulation_holds_several_tiles_per_chunk():
    """The largest case of B8_CASES has more tiles than SMs, so its chunks
    sum several tiles in order before the chunk-order sum."""
    assert tdk.dk_chunks(1 * 12 * 16, 4, 3)[0] > 1


# (B, H, W) of the regression step's dense layers (batch 16, and the
# check batch 2) and ragged maps
DK_CHUNK_SHAPES = [(16, 192, 256), (16, 96, 128), (16, 48, 64), (2, 192, 256), (2, 48, 64),
                   (2, 8, 16), (1, 1, 1), (3, 13, 37)]


@pytest.mark.parametrize("b,h,w", DK_CHUNK_SHAPES)
@pytest.mark.parametrize("cin,cout", [(48, 12), (100, 20), (5, 3)])
def test_dk_chunks_hold_every_tile_once(b, h, w, cin, cout):
    n_tiles = b * -(-h // 8) * -(-w // 32)
    per, n_chunks = tdk.dk_chunks(n_tiles, cin, cout)
    seen = np.zeros(n_tiles, int)
    for z in range(n_chunks):
        lo, hi = z * per, min(n_tiles, (z + 1) * per)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    blocks = n_chunks * -(-cin // 48) * -(-cout // 16)
    # about one block per SM where the tiles allow: at most one round short
    assert blocks <= max(SMS, -(-cin // 48) * -(-cout // 16))
    if n_tiles * -(-cin // 48) * -(-cout // 16) >= 2 * SMS:
        assert blocks >= SMS // 2
