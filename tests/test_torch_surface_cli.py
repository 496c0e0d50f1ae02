"""The port's six new CLIs (needlets_gt, fit_single, verify_parity,
sphere_demo, preview, modify_pickles) against the JAX package's, on the CPU
(--device cpu), on tests/test_cli.py's synthetic Laval-layout root (four
128x256 panoramas with a light, four 192x256 crops)."""

import contextlib
import io
import os
import pickle
import re

import numpy as np
import pytest
from PIL import Image

from emlight_tpu.cli import modify_pickles as j_modify
from emlight_tpu.cli import needlets_gt as j_needlets
from emlight_tpu.cli import preview as j_preview
from emlight_tpu.core.exr import write_exr
from emlight_tpu.core.hdr import TONEMAP_VIZ, read_hdr
from emlight_tpu_torch.cli import fit_single as t_fit
from emlight_tpu_torch.cli import modify_pickles as t_modify
from emlight_tpu_torch.cli import needlets_gt as t_needlets
from emlight_tpu_torch.cli import preview as t_preview
from emlight_tpu_torch.cli import sphere_demo as t_demo
from emlight_tpu_torch.needlets import NeedletPipeline
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

CLIS = ("needlets_gt", "fit_single", "verify_parity", "sphere_demo", "preview",
        "modify_pickles")


@pytest.fixture(scope="module")
def laval_root(tmp_path_factory):
    """tests/test_cli.py's root."""
    root = tmp_path_factory.mktemp("laval")
    (root / "warped").mkdir()
    (root / "crop").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        pano = rng.random((128, 256, 3)).astype(np.float32) * 0.2
        pano[40:44, 60 + 20 * i: 66 + 20 * i] = 300.0  # a light
        write_exr(str(root / "warped" / f"s{i}.exr"), pano)
        crop = rng.random((192, 256, 3)).astype(np.float32)
        write_exr(str(root / "crop" / f"s{i}.exr"), crop)
    return root


def _flags(module_name: str, package: str) -> set[str]:
    import importlib

    main = importlib.import_module(f"{package}.cli.{module_name}").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])--\w+", buf.getvalue())) - {"--help"}


@pytest.mark.parametrize("name", CLIS)
def test_flags_are_the_jax_clis_plus_device(name):
    assert _flags(name, "emlight_tpu_torch") == _flags(name, "emlight_tpu") | {"--device"}


@pytest.mark.parametrize("crops", [False, True])
def test_needlets_gt_matches_jax_cli(laval_root, tmp_path, crops):
    """--jmax 2, sparsified, with and without the crops' tonemap alpha: the
    .npy files at rtol 1e-5 of each file's largest coefficient; a
    coefficient is zero on one side only where its band energy lies within
    1e-5 of the band's threshold."""
    extra = ["--crop_dir", str(laval_root / "crop")] if crops else []
    argv = ["--hdr_dir", str(laval_root / "warped"), "--jmax", "2", "--batch", "2", "--check",
            *extra]
    j_needlets.main(argv + ["--out_dir", str(tmp_path / "jax")])
    st = t_needlets.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert st["panoramas"] == 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    pipe = NeedletPipeline(device="cpu")
    for nm in names:
        ref, got = np.load(tmp_path / "jax" / nm), np.load(tmp_path / "port" / nm)
        assert got.shape == ref.shape == (253, 3) and got.dtype == ref.dtype
        bad = np.abs(got - ref) > 1e-5 * np.abs(ref).max()
        if bad.any():
            import torch

            from emlight_tpu_torch.core.hdr import TONEMAP_INPUT, tonemap_alpha

            img = read_hdr(str(laval_root / "warped" / nm.replace(".npy", ".exr")))
            if crops:
                img = img * np.float64(tonemap_alpha(
                    read_hdr(str(laval_root / "crop" / nm.replace(".npy", ".exr"))),
                    TONEMAP_INPUT, gamma=False))
            dense = pipe.project(torch.as_tensor(img[None], dtype=torch.float32))[0].numpy()
            for sl, pct in zip(pipe.slices, pipe.cfg.sparsity_percentiles):
                energy = np.abs(dense[sl]).sum(-1)
                thre = np.percentile(energy, pct)
                rows = np.nonzero(bad[sl].any(-1))[0]
                assert (np.abs(energy[rows] - thre) <= 1e-5 * thre).all(), (nm, sl)
        zero_ref, zero_got = np.abs(ref).sum(-1) == 0, np.abs(got).sum(-1) == 0
        assert (zero_ref[61:]).mean() > 0.5  # tests/test_cli.py's check
        assert (zero_ref != zero_got).sum() <= bad.any(-1).sum()


def test_preview_matches_jax_tonemap(laval_root, tmp_path):
    """One PNG per panorama, equal to the JAX package's TONEMAP_VIZ x 255 as
    uint8 (the array; the JAX CLI's own files are JPEGs)."""
    j_preview.main(["--hdr_dir", str(laval_root / "warped"), "--out_dir", str(tmp_path / "j")])
    assert t_preview.main(["--hdr_dir", str(laval_root / "warped"),
                           "--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 4
    assert len(list((tmp_path / "j").glob("*.jpg"))) == 4
    for path in sorted((laval_root / "warped").glob("*.exr")):
        with Image.open(tmp_path / "t" / path.name.replace(".exr", ".png")) as im:
            got = np.asarray(im)
        want = (TONEMAP_VIZ(read_hdr(str(path)))[0] * 255).astype(np.uint8)
        np.testing.assert_array_equal(got, want)


def _pickles(d):
    out = {}
    for nm in sorted(os.listdir(d)):
        with open(os.path.join(d, nm), "rb") as f:
            out[nm] = pickle.load(f)
    return out


def test_modify_pickles_matches_jax_cli(laval_root, tmp_path):
    """Scaling: the JAX CLI's pickles exactly (values, types, dtypes);
    --legacy_42: the same keys and shapes, values at rtol 1e-5."""
    src = tmp_path / "pkl"
    src.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        with open(src / f"s{i}.pickle", "wb") as f:
            pickle.dump({"distribution": rng.dirichlet(np.ones(96)).astype(np.float32),
                         "intensity": np.float32(rng.uniform(1, 5)),
                         "rgb_ratio": np.ones(3, np.float32) / 3,
                         "ambient": rng.random(3).astype(np.float32)}, f)
    argv = ["--pkl_dir", str(src), "--scale_intensity", "3.0", "--scale_ambient", "0.5"]
    j_modify.main(argv + ["--out_dir", str(tmp_path / "j")])
    assert t_modify.main(argv + ["--out_dir", str(tmp_path / "t")]) == 3
    ref, got = _pickles(tmp_path / "j"), _pickles(tmp_path / "t")
    assert ref.keys() == got.keys()
    for nm in ref:
        assert ref[nm].keys() == got[nm].keys()
        for k, v in ref[nm].items():
            assert type(got[nm][k]) is type(v) and got[nm][k].dtype == v.dtype
            np.testing.assert_array_equal(got[nm][k], v)

    argv = ["--hdr_dir", str(laval_root / "warped"), "--legacy_42"]
    j_modify.main(argv + ["--out_dir", str(tmp_path / "j42")])
    assert t_modify.main(argv + ["--out_dir", str(tmp_path / "t42"), "--device", "cpu"]) == 4
    ref, got = _pickles(tmp_path / "j42"), _pickles(tmp_path / "t42")
    assert ref.keys() == got.keys()
    for nm in ref:
        assert ref[nm].keys() == got[nm].keys() and got[nm]["distribution"].shape == (42,)
        for k, v in ref[nm].items():
            assert np.shape(got[nm][k]) == np.shape(v)
            np.testing.assert_allclose(got[nm][k], v, rtol=1e-5, err_msg=f"{nm} {k}")


def test_modify_pickles_needs_its_inputs(tmp_path):
    with pytest.raises(SystemExit):
        t_modify.main(["--out_dir", str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        t_modify.main(["--out_dir", str(tmp_path / "o"), "--legacy_42", "--device", "cpu"])
    assert not (tmp_path / "o").exists()


def test_fit_single_writes_its_files(laval_root, tmp_path):
    prefix = str(tmp_path / "fit")
    out = t_fit.main(["--pano", str(laval_root / "warped" / "s1.exr"), "--lights", "2",
                      "--steps", "30", "--height", "32", "--out", prefix, "--device", "cpu"])
    assert out["loss"].shape == (30,) and out["loss"][-1] < out["loss"][0]
    assert out["dirs"].shape == (2, 3)
    env = read_hdr(prefix + ".exr")
    assert env.shape == (32, 64, 3) and np.isfinite(env).all()
    with Image.open(prefix + ".png") as im:
        assert im.mode == "RGB" and im.size == (128, 32)  # the panorama beside its fit


def test_sphere_demo_training_learns(tmp_path, capsys):
    """tests/test_sphere_demo.py's run on the port: well above the 0.1
    chance level after 120 steps; --idx dumps one PNG per index."""
    acc = t_demo.main(["--train", "120", "--batch", "32", "--n_synth", "512",
                       "--outshape", "16,16", "--lr", "3e-3", "--device", "cpu",
                       "--idx", "0", "5", "--out_dir", str(tmp_path)])
    assert acc is not None and acc > 0.3
    for i in (0, 5):
        with Image.open(tmp_path / f"{i}.png") as im:
            assert im.size == (16, 16)
    assert f"{tmp_path / '0.png'}" in capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("needlets_gt", ["--hdr_dir", "x", "--out_dir", "y"]),
    ("fit_single", ["--pano", "x.exr"]),
    ("verify_parity", ["--torch_pth", "x.pth"]),
    ("sphere_demo", ["--train", "1"]),
    ("preview", ["--hdr_dir", "x", "--out_dir", "y"]),
    ("modify_pickles", ["--hdr_dir", "x", "--out_dir", "y", "--legacy_42"]),
])
def test_clis_run_on_cuda_unless_cpu_is_asked(monkeypatch, tmp_path, name, argv):
    """Without --device the CLIs ask for the card, and raise where there is
    none before they read or write a file."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"emlight_tpu_torch.cli.{name}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not list(tmp_path.iterdir())


def test_entry_points_run_on_cuda_unless_cpu_is_asked(monkeypatch):
    import torch

    from emlight_tpu_torch.nn.sphere_demo import OmniDigits
    from emlight_tpu_torch.representation.fit import fit_spherical_gaussians

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeedletPipeline()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_spherical_gaussians(np.zeros((8, 16, 3), np.float32), steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OmniDigits(np.zeros((2, 28, 28)), np.zeros(2))
