"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. This file imports no JAX, so it runs where only PyTorch is
installed (``--noconftest``: the suite's conftest imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every test skips on a machine without a CUDA device (a CUDA kernel has no
CPU mode)."""

import numpy as np
import pytest
import torch

from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_conv_kernel as tker

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


def test_kernel_without_bias(card):
    x, k, _ = _inputs((2, 8, 16, 32), 40, card)
    torch.testing.assert_close(tsc.sphere_conv(x, k, None), tsc.sphere_conv_plain(x, k, None),
                               rtol=1e-4, atol=1e-4)


def test_stride2_on_card_raises(card):
    x, k, bias = _inputs((1, 16, 32, 8), 8, card)
    with pytest.raises(NotImplementedError, match="B2"):
        tsc.sphere_conv(x, k, bias, 2)


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
