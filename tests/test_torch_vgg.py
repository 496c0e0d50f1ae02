"""Port of the VGG19 perceptual loss (emlight_tpu_torch.nn.vgg) against the
JAX package's emlight_tpu/nn/vgg.py, and the train_projector CLI with the
flags that reach it and the fused steps (--vgg_random, --vgg_npz,
--scan_steps, --fused; --device cpu).

The weights are a random-init torch VGG19 written as the npz that
``export_torchvision_weights`` writes (tests/test_vgg.py's format: kernels
HWIO), read by both packages' ``load_vgg19_params``. Inputs are 2x32x64
maps in the HDR range, so the fifth slice is 2x4. Bars: thirteen convs
deep, f32 sums in other orders, features O(10): rtol 1e-4, atol 1e-4 (the
JAX package's own bar against torch), the loss at rtol 1e-5."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit0
from emlight_tpu.nn import vgg as jvgg
from emlight_tpu_torch.cli import train_projector as ttrain_projector
from emlight_tpu_torch.nn import vgg as tvgg
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A random-weight torchvision-layout VGG19 as the exporter's npz."""
    gen = torch.Generator().manual_seed(0)
    arrays, cin = {}, 3
    for i, cout in enumerate(tvgg._WIDTHS):
        w = torch.randn(cout, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        arrays[f"conv{i}_kernel"] = w.numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
        arrays[f"conv{i}_bias"] = (torch.randn(cout, generator=gen) * 0.1).numpy()
        cin = cout
    assert len(arrays) == 2 * len(_CONV_IDS)
    path = tmp_path_factory.mktemp("vgg") / "vgg19.npz"
    np.savez(path, **arrays)
    return str(path)


def _maps(seed):
    return np.random.default_rng(seed).uniform(0, 5, (2, 32, 64, 3)).astype(np.float32)


def test_loaders_read_the_same_tree(npz, monkeypatch):
    ref = jax.tree.map(np.asarray, jvgg.load_vgg19_params(npz))
    got = tvgg.load_vgg19_params(npz)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert len(got["params"]) == 13  # only the convs the slices use
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    monkeypatch.setenv("EMLIGHT_VGG19_NPZ", npz)
    assert np.array_equal(tvgg.load_vgg19_params()["params"]["conv12"]["kernel"],
                          ref["params"]["conv12"]["kernel"])
    monkeypatch.setenv("EMLIGHT_VGG19_NPZ", npz + ".missing")
    assert tvgg.load_vgg19_params() is None
    monkeypatch.delenv("EMLIGHT_VGG19_NPZ")
    assert tvgg.load_vgg19_params(None) is None


def test_random_params_equal_jax_bit_for_bit():
    """--vgg_random is the same model in both packages."""
    for seed in (0, 3):
        ref = jax.tree.map(np.asarray, jvgg.random_vgg19_params(seed))
        got = tvgg.random_vgg19_params(seed)
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_slices_match_jax(npz):
    x = _maps(0)
    variables = jvgg.load_vgg19_params(npz)
    ref = jit0(jvgg.VGG19Features().apply)(variables, jnp.asarray(x))
    vgg = tvgg.VGG19Features(tvgg.load_vgg19_params(npz), device="cpu")
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert [tuple(t.shape) for t in got] == [(2, 32, 64, 64), (2, 16, 32, 128),
                                             (2, 8, 16, 256), (2, 4, 8, 512), (2, 2, 4, 512)]
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"slice {i}", **TOL)
    assert not any(p.requires_grad for p in vgg.parameters())


def test_loss_and_its_gradient_match_jax(npz):
    """The loss, and its gradient with respect to the fake; the real branch
    is detached in both."""
    fake, real = _maps(1), _maps(2)
    variables = jvgg.load_vgg19_params(npz)
    apply = jvgg.VGG19Features().apply
    ref, (g_fake, g_real) = jit0(jax.value_and_grad(
        lambda f, r: jvgg.vgg_perceptual_loss(apply, variables, f, r), argnums=(0, 1)))(
        jnp.asarray(fake), jnp.asarray(real))
    vgg = tvgg.VGG19Features(tvgg.load_vgg19_params(npz), device="cpu")
    tf = torch.from_numpy(fake).requires_grad_(True)
    tr = torch.from_numpy(real).requires_grad_(True)
    loss = tvgg.vgg_perceptual_loss(vgg, tf, tr)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    g = np.asarray(g_fake)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(tf.grad.numpy(), g, rtol=1e-4, atol=1e-4 * np.abs(g).max())
    assert tr.grad is None and not np.asarray(g_real).any()
    assert tvgg.VGG_SLICE_WEIGHTS == jvgg.VGG_SLICE_WEIGHTS


# -- the train_projector CLI with VGG, --scan_steps and --fused ---------------

FLAGS = ["--batch_size", "2", "--ngf", "8", "--ndf", "8", "--crop_size", "64",
         "--anchors", "96", "--device", "cpu"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_scan_steps_then_fused_resume(tmp_path, capsys, monkeypatch):
    """--scan_steps 2 --vgg_random over 3 steps (a chunk of 2 and a ragged
    one), then --resume --fused for a fourth (an epoch of 4 steps): both
    complete, the resumed run starts at the saved step, every metrics row
    is finite and logs VGG."""
    run = str(tmp_path / "run")
    a = ttrain_projector.main(["--synthetic", "6", "--out_dir", run, "--epochs", "1",
                               "--scan_steps", "2", "--vgg_random", "--display_every", "2",
                               "--save_every", "2", *FLAGS])
    assert "VGG19 perceptual loss enabled (random-init weights)" in capsys.readouterr().out
    assert (a["start"], a["step"], a["restored"]) == (0, 3, None)
    assert len(a["wait_s"]) == 3 and a["step_ms"] == []
    # display and save fire once after a chunk that crossed their cadence
    assert sorted(p.name for p in (tmp_path / "run" / "web").iterdir()) == ["2.png"]
    monkeypatch.setattr(ttrain_projector.P, "scanned_fused_steps", None)  # --fused's own loop
    b = ttrain_projector.main(["--synthetic", "8", "--out_dir", run, "--resume", "--fused",
                               "--scan_steps", "0", *FLAGS])  # (opt.json says 2)
    assert "restored checkpoint at step 3" in capsys.readouterr().out
    assert (b["start"], b["step"], b["restored"]) == (3, 4, 3)
    rows = _rows(tmp_path / "run" / "metrics.csv")
    assert [int(r["step"]) for r in rows] == list(range(1, 5))
    keys = {"COS", "D_Fake", "D_real", "GAN", "GAN_Feat", "VGG", "loss_D", "loss_G"}
    assert keys <= set(rows[0])
    assert all(np.isfinite(float(r[k])) for r in rows for k in keys)
    assert all(float(r["VGG"]) > 0 for r in rows)


@pytest.mark.parametrize("flag", [["--fused"], ["--scan_steps", "4"]])
def test_fused_needs_one_d_step_per_g_step(tmp_path, flag):
    """As the JAX CLI: --fused and --scan_steps exit with its message when
    --d_steps_per_g is not 1; here before anything is written."""
    with pytest.raises(SystemExit, match=r"require d_steps_per_g=1"):
        ttrain_projector.main(["--synthetic", "4", "--out_dir", str(tmp_path / "run"),
                               "--d_steps_per_g", "2", *flag, *FLAGS])
    assert not (tmp_path / "run").exists()


def test_vgg_npz_enables_the_pretrained_term(npz, tmp_path, capsys, monkeypatch):
    """--vgg_npz with a file, or $EMLIGHT_VGG19_NPZ, print the JAX CLI's
    message and log the VGG term."""
    monkeypatch.setenv("EMLIGHT_VGG19_NPZ", npz)
    st = ttrain_projector.main(["--synthetic", "2", "--out_dir", str(tmp_path / "run"),
                                "--epochs", "1", "--display_every", "0", *FLAGS])
    assert "VGG19 perceptual loss enabled (pretrained npz)" in capsys.readouterr().out
    assert st["step"] == 1 and "VGG" in _rows(tmp_path / "run" / "metrics.csv")[0]
