"""The port's training and evaluation CLIs (emlight_tpu_torch.cli.
train_regression, train_projector, test_projector, eval_projector,
eval_metrics; --device cpu) against the JAX package's, on a small synthetic
Laval-layout root (4 samples; crops as PIZ HALF and ZIP FLOAT at twice the
model's size; GT pickles of 96 anchors), at tests/test_cli.py's sizes:
--block_config 2 --crop 64,64; --ngf 8 --ndf 8 --crop_size 64.

Each JAX training CLI trains 1 epoch (2 steps of batch 2); a copy of that
run directory is resumed to 2 epochs by the JAX CLI, and another by the
port's (whose restore reads the JAX package's file, optimizer included).
The two final checkpoints, metrics.csv and iter.json are compared at the
training bars of tests/test_torch_train_state.py. The second resumed step
starts from states that differ (a gradient leaf that is rounding noise can
take the opposite Adam step), so each bar is widened, where larger, to
GRAD_SPREAD times the change a third, JAX, resume makes when its images are
jittered by JITTER relative (chip_smoke.py phase 9's measured bar). Then the
eval CLIs of both packages run on the JAX package's final checkpoints;
angles are compared in degrees, and an argmax only where its margin
exceeds the bar of what it is taken over.

The JAX CLIs build their states with create_state; the tests hand them one
cached state per config (built with its init jitted at XLA optimization
level 0, as torch_port_helpers.jax_states does), so that the resumed run
reuses the first run's compiled steps (a fresh optax transformation is a
new static argument, and a recompile of the GAN steps takes about 35 s)."""

import csv
import functools
import json
import pickle
import shutil

import numpy as np
import pytest
import torch

from conftest import jit0
from emlight_tpu.cli import eval_metrics as jeval_metrics
from emlight_tpu.cli import eval_projector as jeval_projector
from emlight_tpu.cli import test_projector as jtest_projector
from emlight_tpu.cli import train_projector as jtrain_projector
from emlight_tpu.cli import train_regression as jtrain_regression
from emlight_tpu.core.exr import read_exr as jread_exr
from emlight_tpu.core.exr import write_exr as jwrite_exr
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu_torch.cli import eval_metrics as teval_metrics
from emlight_tpu_torch.cli import eval_projector as teval_projector
from emlight_tpu_torch.cli import test_projector as ttest_projector
from emlight_tpu_torch.cli import train_projector as ttrain_projector
from emlight_tpu_torch.cli import train_regression as ttrain_regression
from emlight_tpu_torch.core.exr import read_exr
from emlight_tpu_torch.core.geometry import equirect_xyz_splat, steradian_map
from emlight_tpu_torch.core.hdr import TONEMAP_VIZ
from emlight_tpu_torch.train.checkpoint import read_checkpoint
from test_torch_train_state import BARS, GRAD_SPREAD, JITTER, adam_bound
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

N = 4
REG_FLAGS = ["--batch_size", "2", "--anchors", "96", "--block_config", "2", "--crop", "64,64",
             "--summary_every", "1", "--save_every", "1"]
PROJ_FLAGS = ["--batch_size", "2", "--ngf", "8", "--ndf", "8", "--crop_size", "64",
              "--anchors", "96", "--display_every", "1", "--save_every", "2"]
MAP_BAR = {"rtol": 1e-4, "atol": 5e-4}  # tests/test_torch_pipeline.py's env bar
PRED_BAR = {"rtol": 1e-5, "atol": 1e-6}  # and its prediction bar


def _image(rng, h, w, light):
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.15 + 0.1 * np.sin(6 * xx + 2 * yy + rng.uniform(0, 6))[..., None] * [1.0, 0.8, 0.6]
    img = np.round((img + rng.normal(0, 0.01, img.shape)) * 1024) / 1024
    y, x = rng.integers(0, h - 6), rng.integers(0, w - 8)
    img[y:y + 6, x:x + 8] = light
    return img.astype(np.float32)


def _cached(create):
    """create_state, built once per argument set; its init jitted at XLA
    optimization level 0."""
    states = {}

    @functools.wraps(create)
    def cached(rng, cfg, **kw):
        key = (cfg, tuple(sorted(kw.items())))
        if key not in states:
            with pytest.MonkeyPatch.context() as m:
                m.setattr(R, "run_init", lambda init_fn, *args: jit0(init_fn)(*args))
                states[key] = create(rng, cfg, **kw)
        return states[key]

    return cached


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    root = d / "laval"
    rng = np.random.default_rng(9)
    for sub in ("crop", "warped", "pkl"):
        (root / sub).mkdir(parents=True)
    for i in range(N):
        fmt = dict(half=True, compression="piz") if i % 2 == 0 else dict(compression="zip")
        jwrite_exr(str(root / "crop" / f"s{i}.exr"), _image(rng, 128, 128, [40.0, 30.0, 20.0]),
                   **fmt)
        jwrite_exr(str(root / "warped" / f"s{i}.exr"), _image(rng, 64, 128, [60.0, 45.0, 30.0]),
                   **fmt)
        dist = rng.gamma(0.3, 1.0, 96).astype(np.float32)
        gt = {"distribution": dist / dist.sum(), "intensity": np.float32(rng.uniform(100, 900)),
              "rgb_ratio": np.array([0.6, 0.55, 0.58], np.float32),
              "ambient": rng.uniform(1000, 9000, 3).astype(np.float32)}
        with open(root / "pkl" / f"s{i}.pickle", "wb") as f:
            pickle.dump(gt, f)
    # the same images, decoded and jittered, as FLOAT files (no HALF rounding)
    jit_root = d / "laval_jittered"
    shutil.copytree(root / "pkl", jit_root / "pkl")
    for sub in ("crop", "warped"):
        (jit_root / sub).mkdir()
        for i in range(N):
            img = jread_exr(str(root / sub / f"s{i}.exr"))
            img = img * (1 + JITTER * rng.standard_normal(img.shape))
            jwrite_exr(str(jit_root / sub / f"s{i}.exr"), img.astype(np.float32))

    out = {"root": root}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "create_state", _cached(R.create_state))
        m.setattr(P, "create_state", _cached(P.create_state))
        for kind, jmain, tmain, flags in (
                ("reg", jtrain_regression.main, ttrain_regression.main, REG_FLAGS),
                ("proj", jtrain_projector.main, ttrain_projector.main, PROJ_FLAGS)):
            first = d / f"{kind}_epoch1"
            jmain(["--data_root", str(root), "--out_dir", str(first), "--epochs", "1", *flags])
            for who in ("jax", "jit", "port"):
                shutil.copytree(first, d / f"{kind}_{who}")
            resume = ["--resume", "--epochs", "2"]
            jmain(resume + ["--data_root", str(root), "--out_dir", str(d / f"{kind}_jax")])
            jmain(resume + ["--data_root", str(jit_root), "--out_dir", str(d / f"{kind}_jit")])
            out[f"{kind}_stats"] = tmain(resume + ["--data_root", str(root), "--out_dir",
                                                   str(d / f"{kind}_port"), "--device", "cpu"])
            out[kind] = {w: d / f"{kind}_{w}" for w in ("epoch1", "jax", "jit", "port")}

        # the eval CLIs on the JAX package's final checkpoints
        proj_ckpt = str(d / "proj_jax" / "checkpoints" / "latest.msgpack")
        reg_ckpt = str(d / "reg_jax" / "checkpoints" / "latest.msgpack")
        common = ["--data_root", str(root), "--batch", "3"]
        tp = ["--ckpt", proj_ckpt, "--load_config", str(d / "proj_jax")] + common
        jtest_projector.main(tp + ["--out_dir", str(d / "tp_jax")])
        ttest_projector.main(tp + ["--out_dir", str(d / "tp_port"), "--device", "cpu"])
        jeval_projector.main(tp + ["--out", str(d / "ep_jax.json")])
        out["ep_port"] = teval_projector.main(tp + ["--out", str(d / "ep_port.json"),
                                                    "--device", "cpu"])
        em = ["--ckpt", reg_ckpt, "--load_config", str(d / "reg_jax")] + common
        jeval_metrics.main(em + ["--out", str(d / "em_jax.json"), "--eval_apply", "standard"])
        out["em_port"] = teval_metrics.main(em + ["--out", str(d / "em_port.json"),
                                                  "--device", "cpu"])
    out["d"] = d
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("kind", ["reg", "proj"])
def test_resumed_runs_write_what_jax_writes(run, kind):
    """metrics.csv: the same columns in the same order and a row per step,
    the losses of the resumed steps at the training bars' LOSS_RTOL (the
    timings differ); iter.json: the same bookmark; opt.json: the JAX keys
    with the JAX values, plus --device; a preview per step or display."""
    j, t = run[kind]["jax"], run[kind]["port"]
    jr, tr = _rows(j / "metrics.csv"), _rows(t / "metrics.csv")
    jit = _rows(run[kind]["jit"] / "metrics.csv")
    assert tr[0] == jr[0] and len(tr) == len(jr) == 5
    timing = {"time_per_iter", "time_per_item", "iter_p50_s", "iter_p90_s"}
    for a, b, c in zip(jr[1:], tr[1:], jit[1:]):
        assert a[0] == b[0]
        for col, x, y, z in zip(jr[0][1:], a[1:], b[1:], c[1:]):
            assert np.isfinite(float(y)), col
            if col not in timing:
                x, y, z = float(x), float(y), float(z)
                bar = max(1e-4 * abs(x), GRAD_SPREAD * abs(z - x))
                if kind == "proj" and int(a[0]) > 3 and col in ("GAN", "D_Fake", "D_real"):
                    # D's logit bias has a rounding-noise gradient under the
                    # balanced hinge loss (tests/test_torch_projector_train.py):
                    # its step-3 Adam steps may be opposite, shifting every
                    # logit, and these terms, by up to this much
                    bar = max(bar, 2 * 4e-4 * adam_bound(0.0, 0.9, 3))
                assert abs(y - x) <= bar, (a[0], col, y, x, bar)
    assert json.loads((t / "iter.json").read_text()) == json.loads((j / "iter.json").read_text())
    jo, to = json.loads((j / "opt.json").read_text()), json.loads((t / "opt.json").read_text())
    assert set(to) - set(jo) == {"device"} and to["device"] == "cpu"
    assert {k: v for k, v in to.items() if k not in ("out_dir", "device")} == {
        k: v for k, v in jo.items() if k != "out_dir"}
    stats = run[f"{kind}_stats"]
    assert (stats["restored"], stats["start"], stats["step"]) == (2, 2, 4)
    # the JAX run's .jpg of steps 1-2 came with the copied directory
    previews = sorted(p.name for p in (t / ("summary" if kind == "reg" else "web")).iterdir())
    assert previews == ["1.jpg", "2.jpg", "3.png", "4.png"]


@pytest.mark.parametrize("kind", ["reg", "proj"])
def test_final_checkpoints_agree(run, kind):
    """Two steps on from the same restored state and batches: steps and
    counts equal; BatchNorm statistics and spectral u, v at the training
    state bars, and Adam's moments at the gradient bars (each widened by the
    jittered JAX run's spread); every parameter within the most two Adam
    steps of opposite sign can differ, per step taken
    (tests/test_torch_train_state.py); the port's epoch-tagged checkpoint
    equals its latest."""
    def leaves(who):
        path = run[kind][who] / "checkpoints" / "latest.msgpack"
        return dict(_leaves(read_checkpoint(str(path))))

    ref, got, jit = leaves("jax"), leaves("port"), leaves("jit")
    assert set(ref) == set(got) == set(jit)
    bars = BARS["regression" if kind == "reg" else "projector"]

    def moments_of(path):
        return next((path[:path.index(m) + 1] for m in ("mu", "nu") if m in path), None)

    scale, ratio, bar = {}, {}, {}
    for path, a in ref.items():
        if moments_of(path):
            scale[moments_of(path)] = max(scale.get(moments_of(path), 0.0), np.abs(a).max())
    for path, a in ref.items():
        key = moments_of(path)
        if key:
            floor = max(np.abs(a).max(), bars["grad_floor"] * scale[key])
            ratio[path] = np.abs(got[path] - a).max() / floor
            bar[key] = max(bar.get(key, bars["grad_rel"]),
                           GRAD_SPREAD * np.abs(jit[path] - a).max() / floor)
    betas = {"params": (1e-4, 0.9, 0.999), "g_params": (1e-4, 0.0, 0.9),
             "d_params": (4e-4, 0.0, 0.9)}
    n = {"exact": 0, "moment": 0, "state": 0, "param": 0}
    for path, a in ref.items():
        b, where = got[path], "/".join(path)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        if path[-1] in ("count", "step"):
            np.testing.assert_array_equal(b, a, err_msg=where)
            n["exact"] += 1
        elif moments_of(path):
            assert ratio[path] <= bar[moments_of(path)], (where, ratio[path])
            n["moment"] += 1
        elif path[-1] in ("mean", "var", "u", "v"):
            tol = bars["state"]["atol"] + bars["state"]["rtol"] * np.abs(a)
            spread = GRAD_SPREAD * np.abs(jit[path] - a).max()
            assert (np.abs(b - a) <= np.maximum(tol, spread)).all(), where
            n["state"] += 1
        else:
            lr, b1, b2 = betas[path[0]]
            cap = sum(2 * lr * adam_bound(b1, b2, s) for s in (3, 4)) * (1 + 1e-5)
            assert np.abs(b - a).max() <= cap, (where, np.abs(b - a).max(), cap)
            n["param"] += 1
    assert all(n.values()), n
    if kind == "reg":
        tagged = read_checkpoint(str(run[kind]["port"] / "checkpoints" / "2_net.msgpack"))
        assert all(np.array_equal(a, got[p]) for p, a in _leaves(tagged))


def test_test_projector_matches_jax(run):
    """The same .exr maps (at the pipeline's map bar) and a .png per map
    where the JAX CLI writes a .jpg: the uint8 TONEMAP_VIZ of the map."""
    from PIL import Image

    j, t = run["d"] / "tp_jax", run["d"] / "tp_port"
    names = [f"s{i}" for i in range(N)]
    assert sorted(p.name for p in t.iterdir()) == sorted(
        f"{n}.{e}" for n in names for e in ("exr", "png"))
    assert sorted(p.name for p in j.glob("*.exr")) == [f"{n}.exr" for n in names]
    for n in names:
        env, ref = read_exr(str(t / f"{n}.exr")), jread_exr(str(j / f"{n}.exr"))
        assert env.shape == (32, 64, 3) and np.isfinite(env).all()
        np.testing.assert_allclose(env, ref, **MAP_BAR, err_msg=n)
        with Image.open(t / f"{n}.png") as im:
            np.testing.assert_array_equal(np.asarray(im),
                                          (TONEMAP_VIZ(env)[0] * 255).astype(np.uint8))


def _stats_close(got, ref, key, **tol):
    for s in ("mean", "median", "p90"):
        np.testing.assert_allclose(got[key][s], ref[key][s], err_msg=f"{key} {s}", **tol)


def test_eval_projector_matches_jax(run):
    """The same JSON line: keys in the same order, env errors at rtol 1e-4,
    the mean-direction angle within 0.01 degree (arccos near 1 amplifies f32
    differences); the peak direction is compared only where every map's
    brightest pixel leads its second by more than twice the map bar (else
    per map, where it does: the same brightest pixel)."""
    ref = json.loads((run["d"] / "ep_jax.json").read_text())
    got = json.loads((run["d"] / "ep_port.json").read_text())
    assert list(got) == list(ref) and got == run["ep_port"] and got["n_samples"] == N
    _stats_close(got, ref, "env_rmse", rtol=1e-4)
    _stats_close(got, ref, "env_sirmse", rtol=1e-4)
    _stats_close(got, ref, "angular_err_mean_dir_deg", rtol=0, atol=1e-2)
    # the peak: each map's brightest pixel (solid-angle weighted luminance)
    sr = steradian_map(32, 64, multiply=False)
    clear = []
    for i in range(N):
        lum = {}
        for who, read in (("port", read_exr), ("jax", jread_exr)):
            env = read(str(run["d"] / f"tp_{who}" / f"s{i}.exr"))
            lum[who] = ((0.3 * env[..., 0] + 0.59 * env[..., 1] + 0.11 * env[..., 2]) * sr).ravel()
        top = np.sort(lum["jax"])
        if top[-1] - top[-2] > 2 * (MAP_BAR["rtol"] * top[-1] + MAP_BAR["atol"]):
            assert np.argmax(lum["port"]) == np.argmax(lum["jax"]), f"s{i}"
            clear.append(i)
    assert clear, "no map's peak leads its second by more than the map bar"
    if len(clear) == N:
        _stats_close(got, ref, "angular_err_peak_vs_gt_anchor_deg", rtol=0, atol=1e-2)
    assert equirect_xyz_splat(32, 64).shape == (32, 64, 3)


def test_eval_metrics_matches_jax(run):
    """The same JSON line; the top-anchor angle is compared where every
    predicted distribution's top anchor leads its second by more than the
    prediction bar (PRED_BAR) twice over."""
    ref = json.loads((run["d"] / "em_jax.json").read_text())
    got = json.loads((run["d"] / "em_port.json").read_text())
    assert list(got) == list(ref) and got == run["em_port"] and got["n_samples"] == N
    for k in ("dist_rmse", "intensity_rel_err", "rgb_rmse", "ambient_rmse", "env_rmse",
              "env_sirmse"):
        _stats_close(got, ref, k, rtol=1e-4, atol=1e-7)
    _stats_close(got, ref, "angular_err_mean_dir_deg", rtol=0, atol=1e-2)
    from emlight_tpu_torch.cli._common import load_regressor, regression_config
    from emlight_tpu_torch.train import regression as TR
    from emlight_tpu_torch.train.data import RegressionDataset

    cfg = regression_config(96, "64,64", "2", 0.0)
    model = load_regressor(str(run["reg"]["jax"] / "checkpoints" / "latest.msgpack"), cfg, "cpu")
    crops = np.stack([RegressionDataset(str(run["root"]), crop_hw=(64, 64))[i]["crop"]
                      for i in range(N)])
    dist = np.sort(TR.predict(model, torch.from_numpy(crops))["distribution"].numpy(), axis=1)
    margin = dist[:, -1] - dist[:, -2] > 2 * (PRED_BAR["rtol"] * np.abs(dist[:, -1])
                                               + PRED_BAR["atol"])
    assert margin.all(), dist[:, -2:]
    _stats_close(got, ref, "angular_err_deg", rtol=0, atol=1e-2)


UNPORTED = [
    ("train_regression", ["--parallel"], "Multi-GPU"),
    ("train_projector", ["--parallel"], "Multi-GPU"),
    ("test_projector", ["--parallel"], "Multi-GPU"),
]
MAINS = {"train_regression": ttrain_regression.main, "train_projector": ttrain_projector.main,
         "test_projector": ttest_projector.main, "eval_projector": teval_projector.main,
         "eval_metrics": teval_metrics.main}


@pytest.mark.parametrize("cli,flags,item", UNPORTED, ids=[" ".join(u[1]) + " " + u[0]
                                                         for u in UNPORTED])
def test_unported_flags_exit_with_their_roadmap_item(tmp_path, capsys, cli, flags, item):
    """Each exits at parse time (argparse's code 2) naming its ROADMAP.md
    item by title, before anything is written."""
    need = (["--ckpt", "x.msgpack", "--data_root", str(tmp_path)]
            if cli in ("test_projector", "eval_metrics") else
            ["--synthetic", "4", "--out_dir", str(tmp_path / "run")])
    with pytest.raises(SystemExit) as exc:
        MAINS[cli](need + flags + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f'ROADMAP.md §1, "{item}"' in err, err
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("cli", ["train_regression", "train_projector"])
def test_synthetic_batches_train_without_files(tmp_path, cli):
    """--synthetic N: N seeded samples an epoch (the JAX CLIs' synthetic
    batches), no dataset read; a checkpoint and a metrics row per step."""
    flags = REG_FLAGS if cli == "train_regression" else PROJ_FLAGS
    st = MAINS[cli](["--synthetic", "4", "--out_dir", str(tmp_path), "--epochs", "1",
                     "--device", "cpu", *flags])
    assert (st["start"], st["step"], st["restored"]) == (0, 2, None)
    assert len(st["wait_s"]) == 2 and st["step_ms"] == []  # CUDA events only on the card
    assert len(_rows(tmp_path / "metrics.csv")) == 3
    assert (tmp_path / "checkpoints" / "latest.msgpack").exists()


def test_vgg_npz_without_a_file_trains_without_the_term(tmp_path, capsys):
    """As the JAX CLI: a --vgg_npz path that does not exist means no VGG
    weights, and the run trains without the perceptual term."""
    st = ttrain_projector.main(["--synthetic", "2", "--out_dir", str(tmp_path / "run"),
                                "--epochs", "1", "--vgg_npz", str(tmp_path / "none.npz"),
                                "--device", "cpu", "--display_every", "0"] + PROJ_FLAGS[:-4])
    assert st["step"] == 1 and "perceptual term disabled" in capsys.readouterr().out


@pytest.mark.parametrize("cli", sorted(MAINS))
def test_clis_raise_without_a_card(tmp_path, cli, monkeypatch):
    """Without --device cpu and without CUDA each CLI raises before it reads
    or writes a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (["--data_root", str(tmp_path / "none"), "--out_dir", str(tmp_path / "run")]
            if cli.startswith("train") else
            ["--ckpt", "x.msgpack", "--data_root", str(tmp_path / "none")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MAINS[cli](args)
    assert not (tmp_path / "run").exists()
