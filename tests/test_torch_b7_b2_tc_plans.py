"""What can be checked on the CPU of the tensor-core kernels B7 (the dense
layer's fused-affine conv forward, csrc/dense_conv.cu ``fw_kernel``) and B2
(the stride-2 sphere-conv forward, the stride-2 instance of
csrc/sphere_conv_s1.cu):

- their f32 arithmetic, emulated in NumPy, against the JAX package's Pallas
  kernels in interpret mode at the card's f32 bar (rtol = atol = 1e-4):
  - B7 as its implicit GEMM sums out[p] = Σ_t y[p + off_t] K_t: y = x * a + b
    rounded once to f32, 0 outside the image; per 48-channel input slab in
    order, K = (tap, channel) walked in 16-deep steps, each a 3xTF32 product
    (operands split by cutting to TF32) from zero, added in f32; against
    ``fused_affine_conv3x3``'s forward (``_fwd_pallas``);
  - B2 as B1's kernel sums it at stride 2: the sampled operand S in the
    plain version's order, K steps (slab-major: 16 channels of one tap)
    each a 3xTF32 product (rounded to nearest) from zero, added in f32
    within ``s1_plan``'s K splits, the splits added in split order, then
    the bias; against ``sphere_conv_pallas(..., stride=2)``;
  and a single TF32 pass fails the same bar;
- B2's plan: ``s1_plan(..., stride=2)`` covers every output tile and K
  range once at the discriminator's six stride-2 shapes;
- B2's staged rows: every source row a 128-pixel tile reads lies in the
  rows the kernel stages for it (its output rows times 2, widened by the
  stride-2 table's row offsets), which fit the buffer the host sizes; and
  which path shapes stage them (all but the Cin-6 front convs, which gather
  from device memory).

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import dense_conv_pallas as jdc
from emlight_tpu.nn import sphere_conv_pallas as jpal
from emlight_tpu_torch.nn import dense_conv as tdc
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from torch_port_helpers import matmul_1xtf32, matmul_3xtf32, matmul_3xtf32_cut

RTOL = ATOL = 1e-4  # the card's f32 bar for B7 (chip_smoke.py phase 11) and B2 (phase 7)


# --- B7: the implicit GEMM's slabs and 16-deep steps -------------------------

def b7_emulated(x, a, b, k, matmul=matmul_3xtf32_cut):
    """out as B7 sums it: y = x * a + b (one rounding to f32), 0 outside the
    image; per input slab of 48 channels in order, the im2col rows of the
    slab (K = tap-major (tap, channel)) times K in 16-deep steps, each step
    taken by `matmul` from zero and added in f32."""
    bsz, h, w, cin = x.shape
    cout = k.shape[-1]
    y = (x.astype(np.float64) * a + b).astype(np.float32)
    yp = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((bsz * h * w, cout), np.float32)
    for c0 in range(0, cin, 48):
        cs = slice(c0, min(cin, c0 + 48))
        cols = np.concatenate([yp[:, ky:ky + h, kx:kx + w, cs].reshape(-1, cs.stop - c0)
                               for ky in range(3) for kx in range(3)], axis=1)
        kmat = np.concatenate([k[ky, kx, cs] for ky in range(3) for kx in range(3)], axis=0)
        for s in range(0, cols.shape[1], 16):
            acc = acc + matmul(cols[:, s:s + 16], kmat[s:s + 16])
    return acc.reshape(bsz, h, w, cout)


def _dense_inputs(b, h, w, c, o, seed):
    rng = np.random.default_rng(seed)
    return [v.astype(np.float32) for v in (
        rng.standard_normal((b, h, w, c)), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c),
        rng.standard_normal((3, 3, c, o)))]


def _dense_jax(x, a, b, k):
    return np.asarray(jdc.fused_affine_conv3x3(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(k), True))


# the dense layer's widths (48 -> 12), tests/test_densenet_fast.py's 5 -> 3,
# and 100 -> 20 (three input slabs, the last of 4 channels; two output passes)
B7_CASES = [(2, 16, 32, 48, 12), (2, 16, 24, 5, 3), (1, 16, 32, 100, 20)]


@pytest.mark.parametrize("shape", B7_CASES, ids=lambda s: "x".join(map(str, s)))
def test_b7_implicit_gemm_matches_jax_pallas(shape):
    assert jdc.supported(shape[1], shape[2])
    x, a, b, k = _dense_inputs(*shape, seed=41)
    out = b7_emulated(x, a, b, k)
    np.testing.assert_allclose(out, _dense_jax(x, a, b, k), rtol=RTOL, atol=ATOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tdc.conv3x3_nhwc_reference(*(torch.from_numpy(v) for v in (x, a, b, k))).numpy()
    np.testing.assert_allclose(out, plain, rtol=RTOL, atol=ATOL)


def test_b7_single_tf32_pass_fails_the_bar():
    x, a, b, k = _dense_inputs(*B7_CASES[0], seed=41)
    out = b7_emulated(x, a, b, k, matmul_1xtf32)
    assert not np.allclose(out, _dense_jax(x, a, b, k), rtol=RTOL, atol=ATOL)


# --- B2: B1's arithmetic at stride 2 ------------------------------------------

def b2_emulated(x, k, bias, matmul=matmul_3xtf32):
    """out as B2 sums it: per tap t, S_t = Σ_q x[idx] w (the plain version's
    order, in f32); K step s = (16-channel slab s // 9, tap s % 9) taken by
    `matmul` from zero and added in f32 within each of ``s1_plan``'s K
    splits; the splits' partials added in split order, then the bias."""
    bsz, h, w, cin = x.shape
    cout = k.shape[-1]
    idx, wgt, (ho, wo) = tsc.sphere_taps(h, w, 2)
    xf = x.reshape(bsz, h * w, cin)
    s_taps = []
    for t in range(9):
        s = np.zeros((bsz, ho * wo, cin), np.float32)
        for q in range(4):
            s = s + xf[:, idx[:, t, q]] * wgt[:, t, q][None, :, None]
        s_taps.append(s.reshape(-1, cin))
    kf = k.reshape(9, cin, cout)
    plan = tker.s1_plan(bsz, h, w, cin, cout, torch.float32, stride=2)
    out = None
    for z in range(plan.n_split):
        part = np.zeros((bsz * ho * wo, cout), np.float32)
        for step in range(z * plan.per, min(plan.n_steps, (z + 1) * plan.per)):
            slab, t = divmod(step, 9)
            c = slice(slab * plan.bk, min(cin, (slab + 1) * plan.bk))
            part = part + matmul(s_taps[t][:, c], kf[t, c])
        out = part if out is None else out + part
    return (out + bias).reshape(bsz, ho, wo, cout)


def _sphere_inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.normal(0, 0.2, (3, 3, shape[-1], cout)).astype(np.float32),
            rng.normal(0, 0.1, cout).astype(np.float32))


def _sphere_jax(x, k, bias):
    return np.asarray(jpal.sphere_conv_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                              2, block_rows=8, interpret=True))


# two of the discriminator's stride-2 convs cut to batch 2 (the 128 -> 256
# one splits K there; the cin 6 front conv of its second scale), and a
# ragged one (cin and cout off the 16-channel step and the 64/128 tiles)
B2_CASES = [((2, 32, 64, 128), 256), ((2, 64, 128, 6), 64), ((1, 8, 16, 20), 70)]


@pytest.mark.parametrize("shape,cout", B2_CASES, ids=lambda s: "x".join(map(str, s))
                         if isinstance(s, tuple) else str(s))
def test_b2_matches_jax_pallas(shape, cout):
    x, k, bias = _sphere_inputs(shape, cout, seed=42)
    out = b2_emulated(x, k, bias)
    np.testing.assert_allclose(out, _sphere_jax(x, k, bias), rtol=RTOL, atol=ATOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tsc.sphere_conv_plain(torch.from_numpy(x), torch.from_numpy(k),
                                  torch.from_numpy(bias), 2).numpy()
    np.testing.assert_allclose(out, plain, rtol=RTOL, atol=ATOL)


def test_b2_emulation_splits_k():
    """The first case of B2_CASES is cut into K splits, so its split-order
    sum is what the test above holds to the JAX kernel."""
    assert tker.s1_plan(2, 32, 64, 128, 256, torch.float32, stride=2).n_split > 1


def test_b2_single_tf32_pass_fails_the_bar():
    shape, cout = B2_CASES[0]
    x, k, bias = _sphere_inputs(shape, cout, seed=42)
    out = b2_emulated(x, k, bias, matmul_1xtf32)
    assert not np.allclose(out, _sphere_jax(x, k, bias), rtol=RTOL, atol=ATOL)


# --- B2's plan and staged rows ------------------------------------------------

# (B, H, W, Cin, Cout) of the discriminator's stride-2 convs (ndf 64,
# n_layers 4, num_d 2) at its batch 16 (fake and real): the first scale reads
# 128x256, the second 64x128
B2_PATH_SHAPES = [(16, 128, 256, 6, 64), (16, 64, 128, 64, 128), (16, 32, 64, 128, 256),
                  (16, 64, 128, 6, 64), (16, 32, 64, 64, 128), (16, 16, 32, 128, 256)]
# and at chip_smoke.py's check batch 2, --crop_size 512's front conv, and a
# ragged map whose tiles cross rows and images
B2_ROW_SHAPES = (B2_PATH_SHAPES + [(2, *s[1:]) for s in B2_PATH_SHAPES]
                 + [(2, 256, 512, 6, 64), (3, 10, 14, 20, 70)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", B2_PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_s1_plan_at_stride_2_covers_every_tile_and_k_range_once(shape, dtype):
    b, h, w, cin, cout = shape
    plan = tker.s1_plan(*shape, dtype, stride=2)
    assert plan.bk * dtype.itemsize == 64
    m = b * (h // 2) * (w // 2)  # the flat output pixels
    pix = np.zeros(m, int)
    for mt in range(plan.tiles_m):
        pix[mt * plan.bm:(mt + 1) * plan.bm] += 1
    assert (pix == 1).all() and (plan.tiles_m - 1) * plan.bm < m
    chans = np.zeros(cout, int)
    for nt in range(plan.tiles_n):
        chans[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (chans == 1).all() and (plan.tiles_n - 1) * plan.bn < cout
    k_cover = np.zeros((9, cin), int)
    for split in range(plan.n_split):
        steps = range(split * plan.per, min(plan.n_steps, (split + 1) * plan.per))
        assert len(steps) > 0
        for s in steps:
            slab, tap = divmod(s, 9)
            k_cover[tap, slab * plan.bk:(slab + 1) * plan.bk] += 1
    assert (k_cover == 1).all()
    # the 128 -> 256 convs split K (16 and 64 tiles of 72 f32 steps); the
    # others have 64 to 1024 tiles of at most 36 steps and stay whole
    assert (plan.n_split > 1) == (cin * cout >= 1 << 15)


def test_s1_plan_at_stride_1_is_unchanged():
    """The stride argument leaves B1's plans as they were: the 16x32 512 ->
    3 conv (cin * cout below B1's 2**17) stays whole, the 4x8 1024 -> 1024
    one splits."""
    assert tker.s1_plan(16, 16, 32, 512, 3) == tker.s1_plan(16, 16, 32, 512, 3, stride=1)
    assert tker.s1_plan(16, 16, 32, 512, 3).n_split == 1
    assert tker.s1_plan(8, 4, 8, 1024, 1024).n_split > 1


def _table_rows(b, ho, wo, bm=128):
    """csrc/sphere_conv_s1.cu's table_rows: the most flat output rows a tile
    of bm pixels spans."""
    return min((wo - math.gcd(bm, wo) + bm - 1) // wo + 1, b * ho)


@pytest.mark.parametrize("shape", B2_ROW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_b2_tiles_read_only_their_staged_rows(shape):
    """For every 128-pixel tile, every (row, i, t, k) entry its pixels read
    (flat input row b * H + rows[i, t, k]) lies in [fr_lo, fr_hi], the rows
    the kernel stages: its flat output rows f0..f1 mapped to 2 f0 + dmin ..
    2 f1 + dmax with the stride-2 ``_device_s1_table`` offsets, clamped to
    the batch; and those fit the buffer the host sizes (source_rows)."""
    b, h, w, _, _ = shape
    ho, wo = h // 2, w // 2
    table, dmin, dmax = tker._device_s1_table(h, w, 2, "cpu")
    rows = table.numpy()[..., 0]  # (ho, 9, 4) source rows
    assert dmin <= 0 <= dmax
    offsets = rows - 2 * np.arange(ho)[:, None, None]
    assert offsets.min() >= dmin and offsets.max() <= dmax
    m = b * ho * wo
    span = _table_rows(b, ho, wo)
    source_rows = min(2 * (span - 1) + dmax - dmin + 1, b * h)
    p = np.arange(m)
    fo = p // wo
    read = ((fo // ho) * h)[:, None, None] + rows[fo % ho]  # (m, 9, 4) flat input rows
    for m0 in range(0, m, 128):
        m1 = min(m0 + 128, m)
        f0, f1 = m0 // wo, (m1 - 1) // wo
        assert f1 - f0 + 1 <= span
        fr_lo = max(0, 2 * f0 + dmin)
        fr_hi = min(b * h - 1, 2 * f1 + dmax)
        assert fr_hi - fr_lo + 1 <= source_rows
        tile = read[m0:m1]
        assert tile.min() >= fr_lo and tile.max() <= fr_hi, (m0, tile.min(), tile.max())


def _b2_stages(b, h, w, cin, cout, dtype):
    """csrc/sphere_conv_s1.cu's launch_bn at stride 2: the source rows are
    staged when two buffers of them, the 3-stage ring (A and B tiles, f32 as
    TF32 hi and lo) and the table fit the 232448 bytes of shared memory a
    block can have, and Cin is a multiple of the 16-byte vector."""
    ho, wo = h // 2, w // 2
    bn = 128 if cout > 64 else 64
    esize, parts, vec = (4, 2, 4) if dtype == torch.float32 else (2, 1, 8)
    stage = parts * (128 + bn) * 64  # the A and B tiles of one 64-byte K step
    tab_off = 3 * stage + 2 * 3 * 8
    _, dmin, dmax = tker._device_s1_table(h, w, 2, "cpu")
    span = _table_rows(b, ho, wo)
    tab_bytes = span * 36 * 16 if span * 36 * 16 <= 16384 else 0
    rows_bytes = min(2 * (span - 1) + dmax - dmin + 1, b * h) * w * 64
    return tab_off + tab_bytes + 2 * rows_bytes <= 232448 and cin % vec == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b2_stages_its_rows_except_the_cin6_convs(dtype):
    """Which B2 shapes of the training path stage their source rows in
    shared memory and which gather from device memory: every conv with 64
    or 128 input channels stages; the Cin 6 front convs (6 is no multiple of
    the 16-byte vector), and --crop_size 512's 256x512 one, gather."""
    staged = {s: _b2_stages(*s, dtype) for s in B2_PATH_SHAPES + [(2, 256, 512, 6, 64)]}
    assert staged == {s: s[3] != 6 for s in staged}
