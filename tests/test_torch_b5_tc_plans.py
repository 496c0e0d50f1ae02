"""What can be checked on the CPU of B5, the stride-2 sphere-conv dx, which
runs as the stride-2 instance of csrc/sphere_conv_dx_triple.cu (B6's U GEMM
and gather):

- its f32 arithmetic, emulated in NumPy (``torch_port_helpers.dx_emulated``
  at stride 2): U = g K_tᵀ over g's pixels in ``triple_tiles``' K splits of
  16-channel 3xTF32 steps, then per input row and column parity the gather
  over that parity's slot list of ``parity_tables`` in slot order; against
  ``_dx_pallas(..., 2, interpret=True)`` (the JAX package's
  ``_dx_kernel_s2``) and ``dx_plain`` at the card's f32 bar;
- the parity lists: every live slot of ``inverse_tables(h, w, 2)`` once, in
  the list of its shift's parity, in slot order; 13 slots at most on every
  map from 8x16 to 256x512; and a gather over them sums exactly what a
  gather over all of a row's slots sums (the other parity's slots add
  nothing), bit for bit;
- padded slots and the dead column are skipped: an inf in g reaches dx only
  where it reaches the plain version;
- the plan: at the training path's batch 16 every B5 shape fills 2 x 132
  blocks without a K split; only the smaller check batches split.

The kernel itself runs on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn import sphere_conv_vjp as jvjp
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from emlight_tpu_torch.nn import sphere_conv_vjp as tvjp
from test_torch_b7_b2_tc_plans import B2_PATH_SHAPES
from torch_port_helpers import dx_emulated, gather_emulated

DX_TOL = 1e-4  # the card's f32 bar for dx (chip_smoke.py phase 7)
SMS = 132      # an H100's SMs


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    k = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    g = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2, cout)).astype(np.float32)
    return k, g


# (x shape, cout): Cin 6 (the front convs) and 5 (the scalar gather), Cin 10
# off the 4-channel chunk, Cout 3 (one ragged K step), a K cut into splits
# (70 on one tile: 3 splits of 32; 40 on four tiles: 2), W off the 64-pixel
# tile (8x20 -> 4x10 pixels of g)
B5_CASES = [((2, 8, 16, 6), 16), ((1, 8, 16, 5), 8), ((2, 8, 16, 10), 24), ((2, 8, 16, 8), 3),
            ((1, 8, 16, 12), 70), ((1, 16, 32, 16), 40), ((2, 8, 20, 4), 12)]


@pytest.mark.parametrize("shape,cout", B5_CASES)
def test_b5_gemm_and_parity_gather_match_jax_pallas(shape, cout):
    k, g = _inputs(shape, cout, seed=41)
    out = dx_emulated(g, k, shape, 2)
    ref = np.asarray(jvjp._dx_pallas(jnp.asarray(g), jnp.asarray(k), shape, 2, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=DX_TOL, atol=DX_TOL)
    # and it tracks the port's plain version (the card's oracle) as closely
    plain = tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), shape, 2).numpy()
    np.testing.assert_allclose(out, plain, rtol=DX_TOL, atol=DX_TOL)


def test_b5_emulation_cuts_k():
    """The split cases of B5_CASES really are cut (the plan over g's map), so
    their split-order sums are what the test above holds to the JAX kernel;
    the others are not."""
    splits = {(s, c): tker.triple_tiles(s[0], s[1] // 2, s[2] // 2, s[3], c).n_split
              for s, c in B5_CASES}
    assert splits[(1, 8, 16, 12), 70] == 3 and splits[(1, 16, 32, 16), 40] == 2
    assert sum(n > 1 for n in splits.values()) == 2


MAPS = [(8, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512)]


@pytest.mark.parametrize("h,w", MAPS)
def test_parity_lists_hold_every_live_slot_once_in_slot_order(h, w):
    *tabs, fanin = tvjp.inverse_tables(h, w, 2)
    *ptabs, f2 = tker.parity_tables(h, w)
    assert f2 == 13 and fanin == 26
    shifts, w0 = tabs[2], tabs[3]
    for a, t in zip(ptabs, tabs):
        assert a.shape == (h, 2, f2) and a.dtype == t.dtype
    porow, pw0 = ptabs[0], ptabs[3]
    assert (porow >= 0).all() and (porow < h // 2).all()  # padding too: in range
    for r in range(h):
        # the live slots of each parity, in slot order, between them all of them
        lists = [[m for m in range(fanin) if w0[r, m] > 0 and shifts[r, m] % 2 == p]
                 for p in (0, 1)]
        assert sorted(lists[0] + lists[1]) == [m for m in range(fanin) if w0[r, m] > 0]
        for p, ms in enumerate(lists):
            for a, t in zip(ptabs, tabs):
                np.testing.assert_array_equal(a[r, p, :len(ms)], t[r, ms])
            assert (pw0[r, p, len(ms):] == 0).all()


@pytest.mark.parametrize("h,w", [(8, 16), (16, 32), (8, 20)])
def test_parity_gather_sums_what_the_all_slot_gather_sums(h, w):
    """Given the same U, the gather over a column's parity list equals bit for
    bit the gather over all of its row's slots in slot order, each slot
    taken only where (col - s) mod W is even."""
    rng = np.random.default_rng(h * w)
    b, cin = 2, 5
    u = rng.standard_normal((b, h // 2, w // 2, 9, cin)).astype(np.float32)
    orow, taps, shifts, w0, jdev, fanin = tvjp.inverse_tables(h, w, 2)
    ref = np.zeros((b, h, w, cin), np.float32)
    cols = np.arange(w)
    for r in range(h):
        acc = np.zeros((b, w, cin), np.float32)
        for m in range(fanin):
            if w0[r, m] == 0:
                continue
            d = (cols - shifts[r, m]) % w
            j = d // 2
            term = u[:, orow[r, m], j, taps[r, m]] * w0[r, m]
            acc = np.where(((d % 2 == 0) & (j != jdev[r, m]))[None, :, None], acc + term, acc)
        ref[:, r] = acc
    np.testing.assert_array_equal(gather_emulated(u, (b, h, w, cin), 2), ref)


def test_b5_skips_padded_slots_and_the_dead_column():
    """An inf in g reaches dx only through live slots off the dead column:
    wherever the plain version is finite, the emulation is too."""
    shape, cout = (1, 8, 16, 8), 8
    k, g = _inputs(shape, cout, seed=42)
    g[0, 2, 5, 3] = np.inf
    with np.errstate(invalid="ignore", over="ignore"):
        out = dx_emulated(g, k, shape, 2)
    plain = tvjp.dx_plain(torch.from_numpy(g), torch.from_numpy(k), shape, 2).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(plain))
    assert not np.isfinite(plain).all() and np.isfinite(plain).any()


@pytest.mark.parametrize("shape", B2_PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_b5_path_shapes_fill_the_card_without_a_split(shape):
    """Every stride-2 dx of the training path (the discriminator's six
    stride-2 convs at its batch 16) has at least 2 x 132 tiles over g's
    pixels and N = 9 * Cin, so K is not cut; at chip_smoke.py's check batch
    2, K is cut exactly where the tiles fall below that (five of the six)."""
    b, h, w, cin, cout = shape
    plan = tker.triple_tiles(b, h // 2, w // 2, cin, cout)
    assert plan.tiles_m * plan.tiles_n >= 2 * SMS and plan.n_split == 1
    assert plan.tiles_m == -(-b * (h // 2) * (w // 2) // 64)
    small = tker.triple_tiles(2, h // 2, w // 2, cin, cout)
    assert (small.n_split > 1) == (small.tiles_m * small.tiles_n < 2 * SMS)


def test_b5_check_batch_splits_the_narrowest_map():
    """16x32 128 -> 256 at batch 16 has 32 x 9 tiles, just over 2 x 132; at
    batch 2 it has 4 x 9 and K is cut."""
    big = tker.triple_tiles(16, 8, 16, 128, 256)
    assert (big.tiles_m, big.tiles_n, big.n_split) == (32, 9, 1)
    assert tker.triple_tiles(2, 8, 16, 128, 256).n_split > 1


def test_parity_tables_reject_an_odd_map():
    with pytest.raises(ValueError, match="even"):
        tker.parity_tables(8, 15)
