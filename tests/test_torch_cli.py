"""The port's inference CLIs (emlight_tpu_torch.cli.infer and
cli.test_regression, --device cpu) against the JAX package's, as in
tests/test_pipeline.py:158-213: the same JAX checkpoints, opt.json
snapshots and synthetic crop .exr files (PIZ HALF, ZIP FLOAT, ZIP HALF and
uncompressed; one 96x128 crop, so the regressor-side resize runs) go
through both, and their maps, pickles and previews are compared.

The JAX CLIs build their restore templates with create_state; the tests
hand them the (structurally identical) states the checkpoints were saved
from, to skip a second 35 s eager init of the projector on the CPU."""

import dataclasses
import io
import json
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from emlight_tpu.cli import infer as jinfer
from emlight_tpu.cli import test_regression as jtest_regression
from emlight_tpu.config import AnchorConfig, ProjectorConfig, RegressionConfig
from emlight_tpu.core.exr import read_exr as jread_exr
from emlight_tpu.core.exr import write_exr as jwrite_exr
from emlight_tpu.train import checkpoint as jckpt
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu_torch.cli import infer as tinfer
from emlight_tpu_torch.cli import test_regression as ttest_regression
from emlight_tpu_torch.core.exr import read_exr
from emlight_tpu_torch.core.hdr import TONEMAP_INPUT, TONEMAP_TEST, TONEMAP_VIZ, resize_panorama
from emlight_tpu_torch.representation.splat import render_anchor_params
from emlight_tpu_torch.train import pipeline as TPL
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.checkpoint import restore_generator, restore_regressor
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    jax_states,
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
    port_regression_cfg,
)

N_ANCHORS = 16
CROP_SIZE = 64
REG_HW = (48, 64)
BATCH = 3  # 5 crops: a full batch and a ragged one
# crop name -> (H, W, EXR compression, half)
CROPS = {
    "c0": (48, 64, "piz", True),    # the Laval wire format
    "c1": (48, 64, "zip", False),
    "c2": (96, 128, "zip", True),   # resized to the regressor's 48x64
    "c3": (48, 64, "none", False),
    "c4": (48, 64, "piz", True),
}
MAP_BAR = {"rtol": 1e-4, "atol": 5e-4}  # tests/test_torch_pipeline.py's env bar
PRED_BAR = {"rtol": 1e-5, "atol": 1e-6}  # and its pred bar


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Checkpoints, snapshots and crops on disk; both packages' CLIs run on
    them once. Returns the paths and the JAX states."""
    reg_cfg = dataclasses.replace(
        RegressionConfig(), anchors=AnchorConfig(regression_anchors=N_ANCHORS),
        crop_h=REG_HW[0], crop_w=REG_HW[1], block_config=(2,))
    proj_cfg = dataclasses.replace(
        ProjectorConfig(), crop_size=CROP_SIZE, ngf=4, ndf=4,
        anchors=AnchorConfig(n_anchors=N_ANCHORS, env_h=CROP_SIZE // 2, env_w=CROP_SIZE))
    reg_state, proj_state = jax_states(reg_cfg, proj_cfg)
    d = tmp_path_factory.mktemp("cli")
    reg_dir, proj_dir = d / "reg_run", d / "proj_run"
    reg_ckpt = jckpt.save_checkpoint(str(reg_dir / "checkpoints"), reg_state)
    proj_ckpt = jckpt.save_checkpoint(str(proj_dir / "checkpoints"), proj_state)
    (reg_dir / "opt.json").write_text(json.dumps({
        "anchors": N_ANCHORS, "block_config": "2",
        "crop": f"{REG_HW[0]},{REG_HW[1]}", "clip_grad_norm": 0.0, "out_dir": "elsewhere",
    }))
    (proj_dir / "opt.json").write_text(json.dumps({
        "crop_size": CROP_SIZE, "ngf": 4, "ndf": 4, "dtype": "float32", "clip_grad_norm": 0.0,
    }))
    crops = d / "crop"
    crops.mkdir()
    rng = np.random.default_rng(7)
    for name, (h, w, comp, half) in CROPS.items():
        # a smooth noisy background on a 1/1024 grid (ZIP and PIZ compress
        # it) and a Laval-scale light
        yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
        img = 0.15 + 0.1 * np.sin(6 * xx + 2 * yy + rng.uniform(0, 6))[..., None] * [1.0, 0.8, 0.6]
        img = np.round((img + rng.normal(0, 0.01, img.shape)) * 1024) / 1024
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 8)
        img[y:y + 6, x:x + 8] = [60.0, 45.0, 30.0]
        jwrite_exr(str(crops / f"{name}.exr"), img.astype(np.float32), half=half,
                   compression=comp)

    infer_args = ["--reg_ckpt", reg_ckpt, "--proj_ckpt", proj_ckpt,
                  "--reg_config", str(reg_dir), "--proj_config", str(proj_dir),
                  "--crops", str(crops), "--batch", str(BATCH), "--save_pickles"]
    reg_args = ["--ckpt", reg_ckpt, "--load_config", str(reg_dir), "--crops", str(crops),
                "--batch", str(BATCH), "--render"]
    out = {k: d / k for k in ("j_infer", "t_infer", "j_reg", "t_reg")}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "create_state", lambda rng, cfg: reg_state)
        m.setattr(P, "create_state", lambda rng, cfg: proj_state)
        jinfer.main(infer_args + ["--out_dir", str(out["j_infer"])])
        jtest_regression.main(reg_args + ["--out_dir", str(out["j_reg"])])
    stats = tinfer.main(infer_args + ["--out_dir", str(out["t_infer"]), "--device", "cpu"])
    ttest_regression.main(reg_args + ["--out_dir", str(out["t_reg"]), "--device", "cpu"])
    return {"out": out, "stats": stats, "crops": crops, "reg_cfg": reg_cfg,
            "proj_cfg": proj_cfg, "reg_ckpt": reg_ckpt, "proj_ckpt": proj_ckpt,
            "infer_args": infer_args, "reg_args": reg_args}


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _png(path):
    with Image.open(path) as im:
        assert im.mode == "RGB"
        return np.asarray(im)


def test_infer_writes_what_jax_writes(run):
    out = run["out"]
    names = sorted(CROPS)
    assert sorted(p.name for p in out["t_infer"].iterdir()) == sorted(
        f"{n}.{ext}" for n in names for ext in ("exr", "png", "pickle"))
    assert sorted(p.name for p in out["j_infer"].glob("*.exr")) == [f"{n}.exr" for n in names]
    for n in names:
        env = read_exr(str(out["t_infer"] / f"{n}.exr"))
        ref = jread_exr(str(out["j_infer"] / f"{n}.exr"))
        assert env.shape == (CROP_SIZE // 2, CROP_SIZE, 3)
        np.testing.assert_allclose(env, ref, **MAP_BAR, err_msg=n)
    assert run["stats"]["crops"] == 5 and run["stats"]["batches"] == 2
    assert run["stats"]["device_ms"] == []  # CUDA events only on the card


def test_infer_pickles_match_jax(run):
    for n in sorted(CROPS):
        para = _pickle(run["out"]["t_infer"] / f"{n}.pickle")
        ref = _pickle(run["out"]["j_infer"] / f"{n}.pickle")
        assert list(para) == list(ref) == ["distribution", "intensity", "rgb_ratio", "ambient"]
        for k in ref:
            assert type(para[k]) is type(ref[k]), (k, type(para[k]), type(ref[k]))
            assert para[k].dtype == ref[k].dtype == np.float32 and para[k].shape == ref[k].shape
            np.testing.assert_allclose(para[k], ref[k], **PRED_BAR, err_msg=f"{n} {k}")
        assert np.shape(para["intensity"]) == () and para["distribution"].shape == (N_ANCHORS,)
        assert all(not isinstance(v, torch.Tensor) for v in para.values())


def test_infer_previews(run):
    """The .png is exactly the uint8 TONEMAP_VIZ of the port's map. The JAX
    CLI's .jpg is PIL's JPEG of the same array of its own map (checked byte
    for byte), and the two arrays are at most one level apart (the maps
    differ within MAP_BAR)."""
    for n in sorted(CROPS):
        png = _png(run["out"]["t_infer"] / f"{n}.png")
        env = read_exr(str(run["out"]["t_infer"] / f"{n}.exr"))
        np.testing.assert_array_equal(png, (TONEMAP_VIZ(env)[0] * 255).astype(np.uint8))
        ref_env = jread_exr(str(run["out"]["j_infer"] / f"{n}.exr"))
        ref = (TONEMAP_VIZ(ref_env)[0] * 255).astype(np.uint8)
        assert np.abs(png.astype(int) - ref).max() <= 1, n
        buf = io.BytesIO()
        Image.fromarray(ref).save(buf, format="JPEG")
        assert buf.getvalue() == (run["out"]["j_infer"] / f"{n}.jpg").read_bytes(), n


def test_infer_maps_equal_pipeline_inference(run):
    """Each map on disk is, bit for bit, pipeline_inference of the restored
    models on the same preprocessed crops at the same batches."""
    reg_cfg, proj_cfg = port_regression_cfg(run["reg_cfg"]), port_projector_cfg(run["proj_cfg"])
    regressor = restore_regressor(run["reg_ckpt"], TR.make_model(reg_cfg, device="cpu"))
    generator = restore_generator(run["proj_ckpt"], TP.make_models(proj_cfg, device="cpu"))
    names = sorted(CROPS)
    for s in range(0, len(names), BATCH):
        regs, projs = [], []
        for n in names[s:s + BATCH]:
            img, _ = TONEMAP_INPUT(read_exr(str(run["crops"] / f"{n}.exr")))
            regs.append(img if img.shape[:2] == REG_HW else resize_panorama(img, REG_HW[::-1]))
            projs.append(resize_panorama(img, (CROP_SIZE // 2, CROP_SIZE // 2)))
        env, _ = TPL.pipeline_inference(regressor, generator, np.stack(regs), np.stack(projs),
                                        reg_cfg, proj_cfg, device="cpu")
        for i, n in enumerate(names[s:s + BATCH]):
            np.testing.assert_array_equal(read_exr(str(run["out"]["t_infer"] / f"{n}.exr")),
                                          env[i].numpy(), err_msg=n)


def test_test_regression_matches_jax(run):
    """Pickles against the JAX CLI's and against infer's (the same
    regressor on the same crops); the _env.png previews against the JAX
    CLI's PNGs within one level."""
    out = run["out"]
    for n in sorted(CROPS):
        para = _pickle(out["t_reg"] / f"{n}.pickle")
        for ref in (_pickle(out["j_reg"] / f"{n}.pickle"), _pickle(out["t_infer"] / f"{n}.pickle")):
            assert list(para) == list(ref)
            for k in ref:
                assert type(para[k]) is type(ref[k]) and para[k].shape == ref[k].shape
                np.testing.assert_allclose(para[k], ref[k], **PRED_BAR, err_msg=f"{n} {k}")
        png, ref_png = _png(out["t_reg"] / f"{n}_env.png"), _png(out["j_reg"] / f"{n}_env.png")
        assert png.shape == ref_png.shape == (128, 256, 3)
        assert np.abs(png.astype(int) - ref_png).max() <= 1, n


def test_render_keeps_the_second_softmax(run):
    """--render softmaxes the predicted distribution once more, as the
    reference does (emlight_tpu/cli/test_regression.py:146)."""
    n = "c1"
    para = _pickle(run["out"]["t_reg"] / f"{n}.pickle")
    png = _png(run["out"]["t_reg"] / f"{n}_env.png")

    def preview(dist):
        env = render_anchor_params(torch.from_numpy(dist)[None],
                                   torch.tensor([para["intensity"]]),
                                   torch.from_numpy(para["rgb_ratio"])[None],
                                   n=N_ANCHORS, intensity_scale=500.0)
        return (TONEMAP_TEST(np.maximum(env.numpy()[0], 0.0))[0] * 255).astype(np.uint8)

    np.testing.assert_array_equal(png, preview(torch.softmax(
        torch.from_numpy(para["distribution"]), -1).numpy()))
    assert not np.array_equal(png, preview(para["distribution"]))


@pytest.mark.parametrize("cli", ["infer", "test_regression"])
def test_clis_raise_without_a_card(run, cli, monkeypatch):
    """Without --device cpu and without CUDA both CLIs raise, before they
    read a file (the checkpoint and crop paths do not exist)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (["--reg_ckpt", "nowhere.msgpack", "--proj_ckpt", "nowhere.msgpack"]
            if cli == "infer" else ["--ckpt", "nowhere.msgpack"])
    main = tinfer.main if cli == "infer" else ttest_regression.main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args + ["--crops", "nowhere", "--out_dir", str(run["out"]["t_reg"] / "x")])
    assert not (run["out"]["t_reg"] / "x").exists()


@pytest.mark.parametrize("cli", ["infer", "test_regression"])
def test_parallel_exits_with_its_message(run, cli, capsys):
    args = run["infer_args"] if cli == "infer" else run["reg_args"]
    main = tinfer.main if cli == "infer" else ttest_regression.main
    with pytest.raises(SystemExit) as exc:
        main(args + ["--parallel", "--device", "cpu"])
    assert exc.value.code == 2
    assert "ROADMAP.md §1 item 6" in capsys.readouterr().err


def test_eval_apply_takes_only_standard(run, capsys):
    with pytest.raises(SystemExit):
        ttest_regression.main(run["reg_args"] + ["--eval_apply", "fast", "--device", "cpu"])
    assert "invalid choice: 'fast'" in capsys.readouterr().err


def test_infer_bfloat16_and_clip_flags(run, tmp_path):
    """--dtype bfloat16 takes the generator's bf16 compute path: it tracks
    the f32 maps at the JAX package's bf16 bar (rtol 0.05, atol 0.05 of
    max|ref|, tests/test_bf16.py:72) without equalling them; the clip flags
    change nothing (the optimizer state is not read)."""
    out, clip = tmp_path / "bf16", tmp_path / "clip"
    tinfer.main(run["infer_args"] + ["--out_dir", str(out), "--device", "cpu", "--limit", "2",
                                     "--dtype", "bfloat16"])
    tinfer.main(run["infer_args"] + ["--out_dir", str(clip), "--device", "cpu", "--limit", "2",
                                     "--reg_clip_grad_norm", "1.0",
                                     "--proj_clip_grad_norm", "1.0"])
    assert sorted(p.name for p in out.glob("*.exr")) == ["c0.exr", "c1.exr"]
    for n in ("c0", "c1"):
        ref = read_exr(str(run["out"]["t_infer"] / f"{n}.exr"))
        bf = read_exr(str(out / f"{n}.exr"))
        np.testing.assert_allclose(bf, ref, rtol=0.05, atol=0.05 * np.abs(ref).max())
        assert not np.array_equal(bf, ref)
        np.testing.assert_array_equal(read_exr(str(clip / f"{n}.exr")), ref)


def test_config_io_matches_jax(tmp_path, capsys):
    """load_run_config, apply_saved_defaults and report_overrides: the same
    defaults installed and the same overrides reported as the JAX
    package's, from a run directory or its opt.json."""
    import argparse

    from emlight_tpu.train import config_io as jcio
    from emlight_tpu_torch.train import config_io as tcio

    (tmp_path / "opt.json").write_text(json.dumps(
        {"anchors": 16, "crop": "48,64", "load_config": "x", "out_dir": "o", "unknown": 1}))

    def parser():
        ap = argparse.ArgumentParser()
        for flag, default in (("--anchors", 96), ("--crop", "192,256"), ("--out_dir", "r"),
                              ("--load_config", None), ("--resume", False)):
            ap.add_argument(flag, default=default)
        return ap

    for argv in (["--load_config", str(tmp_path)], ["--load_config", str(tmp_path / "opt.json"),
                                                    "--anchors", "8"],
                 ["--resume", "1", "--out_dir", str(tmp_path)], []):
        results = []
        for mod in (jcio, tcio):
            ap = parser()
            saved = mod.apply_saved_defaults(ap, argv, exclude=("out_dir",))
            args = ap.parse_args(argv)
            results.append((saved, vars(args), mod.report_overrides(saved, args)))
        assert results[0] == results[1], argv
    assert tcio.load_run_config(str(tmp_path)) == jcio.load_run_config(str(tmp_path / "opt.json"))
    capsys.readouterr()
