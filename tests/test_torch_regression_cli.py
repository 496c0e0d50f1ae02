"""The port's regression CLIs with the flags this slice ports, against the
JAX package's CLIs on one tiny Laval-layout root: test_regression and
eval_metrics with --eval_apply fast (the concat-free buffer forward, the
default of both) and standard, GT pickles made by both packages'
extract_distribution, the training run's compute dtype taken from
--load_config, and train_regression --dtype bfloat16 (resumed by both
packages from one JAX run) and --remat (which the default buffer forward
does not read, in either package)."""

import csv
import dataclasses
import functools
import json
import pickle
import shutil

import jax
import numpy as np
import pytest

from conftest import jit0
from emlight_tpu.cli import eval_metrics as jeval_metrics
from emlight_tpu.cli import extract_distribution as jextract
from emlight_tpu.cli import test_regression as jtest_regression
from emlight_tpu.cli import train_regression as jtrain_regression
from emlight_tpu.config import AnchorConfig, RegressionConfig
from emlight_tpu.core.exr import write_exr as jwrite_exr
from emlight_tpu.train import checkpoint as jckpt
from emlight_tpu.train import regression as R
from emlight_tpu_torch.cli import eval_metrics as teval_metrics
from emlight_tpu_torch.cli import extract_distribution as textract
from emlight_tpu_torch.cli import test_regression as ttest_regression
from emlight_tpu_torch.cli import train_regression as ttrain_regression
from test_torch_io import _hdr_image
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    no_persistent_cache_writes,
    one_torch_thread,
    randomize_stats,
)

N_ANCHORS = 16
REG_HW = (48, 64)
N = 4
PRED_BAR = {"rtol": 1e-5, "atol": 1e-6}  # tests/test_torch_cli.py's pred bar
BF16_REL = 0.02
TRAIN_FLAGS = ["--batch_size", "2", "--anchors", str(N_ANCHORS), "--block_config", "2",
               "--crop", f"{REG_HW[0]},{REG_HW[1]}", "--summary_every", "0", "--save_every",
               "2", "--synthetic", "4"]


def _cached_create_state():
    """R.create_state built once per config, its init jitted at XLA
    optimization level 0."""
    states = {}
    create = R.create_state

    @functools.wraps(create)
    def cached(rng, cfg, **kw):
        if cfg not in states:
            with pytest.MonkeyPatch.context() as m:
                m.setattr(R, "run_init", lambda init_fn, *args: jit0(init_fn)(*args))
                states[cfg] = create(rng, cfg, **kw)
        return states[cfg]

    return cached


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("reg_cli")
    root = d / "laval"
    for sub in ("crop", "warped"):
        (root / sub).mkdir(parents=True)
    for i in range(N):
        fmt = dict(half=True, compression="piz") if i % 2 == 0 else dict(compression="zip")
        jwrite_exr(str(root / "crop" / f"s{i}.exr"), _hdr_image(*REG_HW, seed=i), **fmt)
        jwrite_exr(str(root / "warped" / f"s{i}.exr"), _hdr_image(32, 64, seed=10 + i), **fmt)
    ext = ["--hdr_dir", str(root / "warped"), "--anchors", str(N_ANCHORS), "--height", "32",
           "--batch", "3"]
    jextract.main(ext + ["--out_dir", str(d / "pkl_jax")])
    textract.main(ext + ["--out_dir", str(root / "pkl"), "--device", "cpu"])

    cfg = dataclasses.replace(
        RegressionConfig(), anchors=AnchorConfig(regression_anchors=N_ANCHORS),
        crop_h=REG_HW[0], crop_w=REG_HW[1], block_config=(2,))
    create = _cached_create_state()
    state = create(jax.random.PRNGKey(0), cfg)
    state = state.replace(batch_stats=randomize_stats(
        {k: dict(v) for k, v in state.batch_stats.items()}, np.random.default_rng(0)))
    ckpt = jckpt.save_checkpoint(str(d / "reg_run" / "checkpoints"), state)
    opt = {"anchors": N_ANCHORS, "block_config": "2", "crop": f"{REG_HW[0]},{REG_HW[1]}",
           "clip_grad_norm": 0.0, "dtype": "float32"}
    (d / "reg_run" / "opt.json").write_text(json.dumps(opt))
    (d / "bf16_run").mkdir()
    (d / "bf16_run" / "opt.json").write_text(json.dumps(dict(opt, dtype="bfloat16")))

    out = {"d": d, "root": root, "ckpt": ckpt}
    common = ["--ckpt", ckpt, "--load_config", str(d / "reg_run")]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "create_state", create)
        for ea in ("fast", "standard"):
            tr = common + ["--crops", str(root / "crop"), "--batch", "3", "--eval_apply", ea]
            jtest_regression.main(tr + ["--out_dir", str(d / f"tr_jax_{ea}")])
            ttest_regression.main(tr + ["--out_dir", str(d / f"tr_port_{ea}"), "--device", "cpu"])
            em = common + ["--data_root", str(root), "--batch", "3", "--eval_apply", ea]
            jeval_metrics.main(em + ["--out", str(d / f"em_jax_{ea}.json")])
            out[f"em_port_{ea}"] = teval_metrics.main(em + ["--out", str(d / f"em_port_{ea}.json"),
                                                            "--device", "cpu"])

        # bf16 training: one JAX epoch, then both packages resume it
        first = d / "bf16_epoch1"
        jtrain_regression.main(TRAIN_FLAGS + ["--out_dir", str(first), "--epochs", "1",
                                              "--dtype", "bfloat16"])
        for who in ("jax", "port", "port_remat"):
            shutil.copytree(first, d / f"bf16_{who}")
        resume = ["--resume", "--epochs", "2"]
        jtrain_regression.main(resume + ["--out_dir", str(d / "bf16_jax")])
    ttrain_regression.main(resume + ["--out_dir", str(d / "bf16_port"), "--device", "cpu"])
    ttrain_regression.main(resume + ["--out_dir", str(d / "bf16_port_remat"), "--device", "cpu",
                                     "--remat"])
    return out


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("eval_apply", ["fast", "standard"])
def test_test_regression_eval_apply_matches_jax(run, eval_apply):
    d = run["d"]
    for i in range(N):
        got = _pickle(d / f"tr_port_{eval_apply}" / f"s{i}.pickle")
        ref = _pickle(d / f"tr_jax_{eval_apply}" / f"s{i}.pickle")
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], **PRED_BAR, err_msg=f"s{i} {k}")


@pytest.mark.parametrize("eval_apply", ["fast", "standard"])
def test_eval_metrics_eval_apply_matches_jax(run, eval_apply):
    """The JSON lines on GT pickles the port's extract_distribution wrote:
    the same keys, every statistic at rtol 1e-4 (angles at 1e-2 degrees)."""
    d = run["d"]
    ref = json.loads((d / f"em_jax_{eval_apply}.json").read_text())
    got = json.loads((d / f"em_port_{eval_apply}.json").read_text())
    assert got == run[f"em_port_{eval_apply}"]
    assert set(got) == set(ref) and got["n_samples"] == ref["n_samples"] == N
    for k, stats in ref.items():
        if k == "n_samples":
            continue
        for s, v in stats.items():
            if k.startswith("angular"):
                np.testing.assert_allclose(got[k][s], v, rtol=0, atol=1e-2, err_msg=f"{k} {s}")
            else:
                np.testing.assert_allclose(got[k][s], v, rtol=1e-4, atol=1e-6, err_msg=f"{k} {s}")


def test_extracted_gt_matches_jax(run):
    for i in range(N):
        got = _pickle(run["root"] / "pkl" / f"s{i}.pickle")
        ref = _pickle(run["d"] / "pkl_jax" / f"s{i}.pickle")
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_load_config_carries_the_runs_dtype(run, tmp_path):
    """A bf16 training run's opt.json makes the eval CLIs compute in bf16:
    the pickles track the f32 ones at bf16's bar without equalling them."""
    d = run["d"]
    ttest_regression.main(["--ckpt", run["ckpt"], "--load_config", str(d / "bf16_run"),
                           "--crops", str(run["root"] / "crop"), "--out_dir", str(tmp_path),
                           "--device", "cpu"])
    for i in range(N):
        got = _pickle(tmp_path / f"s{i}.pickle")
        ref = _pickle(d / "tr_port_fast" / f"s{i}.pickle")
        for k in ref:
            scale = np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= BF16_REL * scale, k
        assert not np.array_equal(got["distribution"], ref["distribution"])


def test_train_regression_bfloat16_matches_jax(run):
    """--dtype bfloat16 resumed from one JAX run: the same rows and
    columns, every loss term of the resumed steps within bf16's 0.02
    relative of the JAX package's."""
    d = run["d"]
    jr, tr = _rows(d / "bf16_jax" / "metrics.csv"), _rows(d / "bf16_port" / "metrics.csv")
    assert tr[0] == jr[0] and len(tr) == len(jr) == 5
    assert json.loads((d / "bf16_port" / "opt.json").read_text())["dtype"] == "bfloat16"
    losses = [c for c in jr[0][1:] if c.endswith("loss")]
    assert losses
    for a, b in zip(jr[3:], tr[3:]):  # the resumed steps
        for col in losses:
            i = jr[0].index(col)
            np.testing.assert_allclose(float(b[i]), float(a[i]), rtol=BF16_REL,
                                       err_msg=f"{a[0]} {col}")


def test_remat_is_not_read_by_the_buffer_forward(run):
    """As in the JAX package, --remat acts on the standard train forward
    only; under the default buffer forward the run is the same step for
    step."""
    d = run["d"]
    plain, remat = _rows(d / "bf16_port" / "metrics.csv"), _rows(d / "bf16_port_remat" / "metrics.csv")
    timing = {"time_per_iter", "time_per_item", "iter_p50_s", "iter_p90_s"}
    cols = [i for i, c in enumerate(plain[0]) if c not in timing]
    assert [[r[i] for i in cols] for r in remat] == [[r[i] for i in cols] for r in plain]
    assert json.loads((d / "bf16_port_remat" / "opt.json").read_text())["remat"] is True
