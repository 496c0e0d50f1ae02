"""The port's reference-.pth parity harness (cli/verify_parity.py), its
torch oracle (train/torch_ref.py) and the projector's .pth importers
(train/torch_import.py) against the JAX package's, on the CPU, at
tests/test_verify_parity_cli.py's sizes: DenseNet (4, 4) with 96 anchors,
the generator at ngf 4 / crop 64, the discriminator at ndf 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.nn.spade import SPADEGenerator
from emlight_tpu.train import torch_import as JI
from emlight_tpu.train import torch_ref as JR
from emlight_tpu_torch.cli import verify_parity as VP
from emlight_tpu_torch.config import ProjectorConfig
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import torch_import as TI
from emlight_tpu_torch.train import torch_ref as TR
from emlight_tpu_torch.train.jax_weights import generator_state_from_jax
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

CROP = 64
GEN_SPREAD = 4.0


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    """The three reference-format checkpoints, as the JAX test writes them."""
    d = tmp_path_factory.mktemp("pth")
    m = TR.build_torch_densenet(block_config=(4, 4), n_anchors=96)
    TR.randomize_densenet(m, seed=0)
    tg = TR.TGenerator(ngf=4, crop_size=CROP)
    TR.randomize(tg, seed=0)
    td = TR.TMultiscaleD(ndf=4, num_d=2, n_layers=4, input_nc=6)
    TR.randomize(td, seed=1)
    paths = {}
    for stage, mod in (("regression", m), ("generator", tg), ("discriminator", td)):
        paths[stage] = str(d / f"{stage}.pth")
        torch.save(mod.state_dict(), paths[stage])
    return paths


@pytest.mark.parametrize("stage", ["regression", "generator", "discriminator"])
def test_verify_parity_passes(pths, stage, capsys):
    """Each stage auto-detected, within the 1e-3 bar, exit code 0."""
    argv = ["--torch_pth", pths[stage], "--device", "cpu"]
    if stage != "regression":
        argv += ["--crop_size", str(CROP)]
    assert VP.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{stage} checkpoint:")
    assert out[-1].startswith(f"{stage}: worst") and out[-1].endswith("PASS")


def test_verify_parity_detects_import_bug(pths, monkeypatch, capsys):
    """The JAX test's FAIL path: a (simulated) bug in the importer trips the
    tolerance and exits nonzero."""
    real = TI.import_densenet_state_dict

    def buggy_import(sd, **kw):
        params, stats = real(sd, **kw)
        params = dict(params)
        params["fc_dist"] = {**params["fc_dist"], "kernel": params["fc_dist"]["kernel"] + 0.5}
        return params, stats

    monkeypatch.setattr(TI, "import_densenet_state_dict", buggy_import)
    assert VP.main(["--torch_pth", pths["regression"], "--device", "cpu"]) == 1
    assert capsys.readouterr().out.splitlines()[-1].endswith("FAIL")


def test_verify_parity_stage_detection():
    assert VP._detect_stage({"fc_dist.weight": 0}) == "regression"
    with pytest.raises(SystemExit):
        VP._detect_stage({"something.else": 0})


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _same_tree(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x = np.asarray(x)
        assert x.dtype == y.dtype and np.array_equal(x, y), p


def test_importers_match_jax(pths):
    """The two new importers (and the regressor's) give the JAX package's
    trees leaf for leaf, from a .pth path and from a dict."""
    sd = {k: v.numpy() for k, v in torch.load(pths["generator"], weights_only=True).items()}
    for src in (sd, pths["generator"]):
        got, ref = TI.import_generator_state_dict(src, ngf=4), JI.import_generator_state_dict(
            src, ngf=4)
        _same_tree({"p": got[0], **got[1]}, {"p": ref[0], **ref[1]})
    sd = {k: v.numpy() for k, v in torch.load(pths["discriminator"], weights_only=True).items()}
    got, ref = TI.import_discriminator_state_dict(sd), JI.import_discriminator_state_dict(sd)
    _same_tree({"p": got[0], **got[1]}, {"p": ref[0], **ref[1]})
    sd = {k: v.numpy() for k, v in torch.load(pths["regression"], weights_only=True).items()}
    got = TI.import_densenet_state_dict(sd, block_config=(4, 4))
    ref = JI.import_densenet_state_dict(sd, block_config=(4, 4))
    _same_tree({"p": got[0], "s": got[1]}, {"p": ref[0], "s": ref[1]})


def test_oracle_copy_matches_jax_package_oracle(pths):
    """train/torch_ref.py computes what the JAX package's copy computes,
    bit for bit, on the same state dicts (the discriminator and the
    DenseNet; the generator's sphere convs are the discriminator's
    TSphereConv)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((1, 6, CROP // 2, CROP), dtype=np.float32))
    crop = torch.from_numpy(rng.random((1, 3, 96, 128), dtype=np.float32))
    sd_d = torch.load(pths["discriminator"], weights_only=True)
    sd_r = torch.load(pths["regression"], weights_only=True)
    outs = []
    for ref_mod in (TR, JR):
        d = ref_mod.TMultiscaleD(ndf=4, num_d=2, n_layers=4, input_nc=6)
        d.load_state_dict(sd_d)
        m = ref_mod.build_torch_densenet(block_config=(4, 4), n_anchors=96)
        m.load_state_dict(sd_r)
        with torch.no_grad():
            outs.append([f for feats in d.eval()(x) for f in feats]
                        + list(m.eval().fwd(crop).values()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    np.testing.assert_array_equal(TR.reference_grid(8, 16, 2).numpy(),
                                  JR.reference_grid(8, 16, 2).numpy())


def test_imported_generator_matches_jax_imported_generator(pths):
    """A reference netG imported into each package: the port's generator
    against the JAX package's at tests/test_torch_spade.py's bar or, where
    larger, GEN_SPREAD times the JAX package's own error on this input, the
    most its generator lies from the torch oracle (train/torch_ref.py, the
    reference's function written independently of both). The reference's
    random weights (N(0, 0.1^2), biases and BN statistics too) leave some
    pixels on tanh's steep part, where f32 rounding shows: there the JAX
    package lies 2.2e-3 from the oracle (of a 0-50 range; 1.9e-3 compiled
    at XLA level 3), the port 2.8e-3, and the port's own result moves by
    about 1e-3 with its thread count."""
    params, stats = JI.import_generator_state_dict(pths["generator"], ngf=4)
    tparams, tstats = TI.import_generator_state_dict(pths["generator"], ngf=4)
    g = TP.make_models(ProjectorConfig(ngf=4, crop_size=CROP), device="cpu")
    g.load_state_dict(generator_state_from_jax(tparams, tstats), strict=True)
    rng = np.random.default_rng(0)
    guide = (rng.random((2, CROP // 2, CROP, 3)) * 4.0).astype(np.float32)
    crop = rng.random((2, CROP // 2, CROP // 2, 3), dtype=np.float32)
    jg = SPADEGenerator(ngf=4, norm_type="syncbatch", crop_size=CROP)
    ref = np.asarray(jax.jit(lambda v, a, c: jg.apply(v, a, c, train=False))(
        {"params": params, **stats}, jnp.asarray(guide), jnp.asarray(crop)))
    oracle = TR.TGenerator(ngf=4, crop_size=CROP)
    oracle.load_state_dict(torch.load(pths["generator"], weights_only=True))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    with torch.inference_mode():
        out = g(torch.from_numpy(guide), torch.from_numpy(crop)).numpy()
        truth = oracle.eval()(nchw(guide), nchw(crop)).numpy().transpose(0, 2, 3, 1)
    # outputs span 0-50: atol 5e-4 is 1e-5 of the range
    bar = np.maximum(1e-4 * np.abs(ref) + 5e-4, GEN_SPREAD * np.abs(ref - truth).max())
    assert out.shape == ref.shape and (np.abs(out - ref) <= bar).all()
