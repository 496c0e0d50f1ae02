"""The port's data pipeline and loop services (emlight_tpu_torch.train.data,
.loop, .config_io::save_run_config) against the JAX package's, on a small
synthetic Laval-layout root: crops and warped panoramas as PIZ HALF and ZIP
FLOAT .exr files (at twice the model's size, so the datasets resize), GT
pickles, and files without a partner (which neither package pairs)."""

import argparse
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from emlight_tpu.core.exr import write_exr as jwrite_exr
from emlight_tpu.representation.splat import render_anchor_params as jrender
from emlight_tpu.train import config_io as jcio
from emlight_tpu.train import data as jdata
from emlight_tpu.train import loop as jloop
from emlight_tpu_torch.core.hdr import TONEMAP_VIZ
from emlight_tpu_torch.train import config_io as tcio
from emlight_tpu_torch.train import data as tdata
from emlight_tpu_torch.train import loop as tloop
from torch_port_helpers import no_persistent_cache_writes, one_torch_thread  # noqa: F401

N = 5  # paired samples; one more pickle without images, one crop without a pickle
CROP_HW, ENV_HW, CROP_SIZE = (48, 64), (32, 64), 32


def _image(rng, h, w):
    """A smooth dim background with a little noise and a Laval-scale light,
    on a 1/1024 grid (so that PIZ and ZIP compress it)."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.15 + 0.1 * np.sin(6 * xx + 2 * yy + rng.uniform(0, 6))[..., None] * [1.0, 0.8, 0.6]
    img = np.round((img + rng.normal(0, 0.01, img.shape)) * 1024) / 1024
    y, x = rng.integers(0, h - 6), rng.integers(0, w - 8)
    img[y:y + 6, x:x + 8] = rng.uniform(20.0, 60.0, 3)
    return img.astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.default_rng(5)
    r = tmp_path_factory.mktemp("laval")
    for d in ("crop", "warped", "pkl"):
        (r / d).mkdir()
    for i in range(N + 1):
        name = f"scene{i}"
        fmt = dict(half=True, compression="piz") if i % 2 == 0 else dict(compression="zip")
        if i < N:  # scene5 has a pickle only
            jwrite_exr(str(r / "crop" / f"{name}.exr"), _image(rng, 2 * CROP_HW[0],
                                                             2 * CROP_HW[1]), **fmt)
            jwrite_exr(str(r / "warped" / f"{name}.exr"), _image(rng, 2 * ENV_HW[0],
                                                               2 * ENV_HW[1]), **fmt)
        dist = rng.gamma(0.3, 1.0, 16).astype(np.float32)
        gt = {"distribution": dist / dist.sum(), "intensity": np.float32(rng.uniform(100, 900)),
              "rgb_ratio": np.array([0.6, 0.55, 0.58], np.float32),
              "ambient": rng.uniform(1000, 9000, 3).astype(np.float32)}
        with open(r / "pkl" / f"{name}.pickle", "wb") as f:
            pickle.dump(gt, f)
    jwrite_exr(str(r / "crop" / "orphan.exr"), _image(rng, *CROP_HW))
    return r


@pytest.mark.parametrize("which", ["regression", "projector"])
def test_dataset_items_match_jax(root, which):
    """The same pairs in the same order; images within 1e-6 (the port's
    INTER_AREA against cv2's, the decoders bit for bit), the targets
    alpha-scaled alike, the names equal."""
    if which == "regression":
        j, t = (m.RegressionDataset(str(root), crop_hw=CROP_HW) for m in (jdata, tdata))
        assert j.pairs == t.pairs and len(t) == N
    else:
        j, t = (m.ProjectorDataset(str(root), crop_size=CROP_SIZE) for m in (jdata, tdata))
        assert j.samples == t.samples and len(t) == N and t.env_hw == ENV_HW
    for i in range(N):
        a, b = j[i], t[i]
        assert list(a) == list(b)
        for k in a:
            if k == "name":
                assert a[k] == b[k] == f"scene{i}"
                continue
            assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, (i, k)
            assert np.shape(b[k]) == np.shape(a[k]), (i, k)
            tol = dict(rtol=1e-6, atol=1e-6) if k in ("crop", "warped") else dict(rtol=1e-6)
            np.testing.assert_allclose(b[k], a[k], err_msg=f"{i} {k}", **tol)
        if which == "projector":
            assert b["map"].any() and not b["map"].all()


@pytest.mark.parametrize("kw", [dict(seed=0, epochs=2), dict(seed=3, epochs=3, drop_last=False),
                                dict(seed=1, epochs=1, shuffle=False)])
def test_batched_order_matches_jax(kw):
    """The same batches in the same order for a seed and an epoch count,
    strings as lists; a resumed run that restarts at seed 0 replays them."""
    ds = [{"x": np.full((2,), i, np.float32), "name": f"s{i}"} for i in range(7)]
    a = list(jdata.batched(ds, 3, **kw))
    b = list(tdata.batched(ds, 3, **kw))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert y["name"] == x["name"] and isinstance(y["name"], list)
        np.testing.assert_array_equal(y["x"], x["x"])
    again = list(tdata.batched(ds, 3, **kw))
    assert all(np.array_equal(x["x"], y["x"]) for x, y in zip(again, b))


def test_prefetch_runs_ahead_and_raises_on_the_consumer():
    seen = []

    def slow():
        for i in range(5):
            seen.append(threading.current_thread() is threading.main_thread())
            yield i

    assert list(tdata.prefetch(slow(), depth=2)) == list(range(5))
    assert not any(seen)

    def broken():
        yield 1
        raise KeyError("bad sample")

    with pytest.raises(KeyError, match="bad sample"):
        list(tdata.prefetch(broken()))


def test_prefetch_thread_stops_when_the_consumer_does():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = tdata.prefetch(endless(), depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n <= 5


def test_device_prefetch_on_the_cpu():
    """Arrays become tensors (one batch ahead), strings and lists pass
    through; on the CPU no copy is made."""
    batches = [{"x": np.arange(4, dtype=np.float32) + i, "name": [f"a{i}", f"b{i}"]}
               for i in range(3)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(1)
            yield b

    it = tdata.device_prefetch(source(), "cpu")
    arrays, rest = next(it)
    assert len(pulled) == 2  # batch 1 is on its way while batch 0 is used
    assert isinstance(arrays["x"], torch.Tensor) and rest == {"name": ["a0", "b0"]}
    assert np.shares_memory(arrays["x"].numpy(), batches[0]["x"])
    assert [r["name"] for _, r in it] == [["a1", "b1"], ["a2", "b2"]]


def test_save_run_config_writes_what_jax_writes(tmp_path):
    args = argparse.Namespace(out_dir="runs/x", anchors=96, crop="192,256", resume=True,
                              load_config="old", lr=1e-4, dtype="float32", parallel=False,
                              block_config="2,2", clip_grad_norm=0.0, vgg_npz=None)
    j = jcio.save_run_config(str(tmp_path / "j"), args)
    t = tcio.save_run_config(str(tmp_path / "t"), args)
    for name in ("opt.json", "opt.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert os.path.basename(t) == os.path.basename(j) == "opt.json"


def test_metrics_logger_and_iteration_timer_match_jax(tmp_path, capsys):
    """metrics.csv byte for byte (columns in the same order, a header only
    when the file is new), iter.json the same, the timer's statistics keys."""
    rows = [(1, {"b": 1.5, "a": torch.tensor(2.0)}, {"t": 0.1}), (2, {"b": 0.5, "a": 3}, None),
            (3, {"b": np.float32(0.25), "a": 1}, {"t": 0.3})]
    for mod, d in ((jloop, tmp_path / "j"), (tloop, tmp_path / "t")):
        for _ in range(2):  # a resumed run appends to the same file
            log = mod.MetricsLogger(str(d), echo_every=2)
            for step, m, extra in rows:
                log.log(step, {k: float(v) for k, v in m.items()}, extra)
        timer = mod.IterationTimer(str(d), batch_size=4)
        for _ in range(3):
            with timer:
                pass
        timer.record()
        again = mod.IterationTimer(str(d)).resume()
        assert (again.step, again.epoch) == (3, 0)
        assert set(timer.stats()) == {"time_per_iter", "time_per_item", "iter_p50_s",
                                      "iter_p90_s"}
    for name in ("metrics.csv", "iter.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out.count("step 2: b: 0.5, a: 3") == 4  # both packages, both runs
    assert tloop.IterationTimer(str(tmp_path), device="cpu").sync is False


def test_nan_guard_matches_jax():
    for mod in (jloop, tloop):
        g = mod.NaNGuard(patience=1)
        g.check(1, {"loss": 1.0})
        g.check(2, {"loss": float("nan")})  # within patience
        g.check(3, {"loss": 2.0})
        g.check(4, {"loss": float("inf")})
        with pytest.raises(FloatingPointError, match=r"step 5: \{'loss': nan\}"):
            g.check(5, {"loss": torch.tensor(float("nan"))})


def test_render_summary_arrays_match_jax(tmp_path):
    """The summary's unresized panels against the JAX package's: the crop,
    and the GT and predicted env maps (splat of the anchor parameters,
    clipped at 0) at the splat bar of tests/test_torch_spade.py (rtol 2e-5
    of the map, against a reference compiled at XLA's default optimization
    level); the PNG is the three 256x256 panels side by side."""
    import jax

    rng = np.random.default_rng(2)
    dist = rng.dirichlet(np.ones(16)).astype(np.float32)
    pred = (dist + rng.normal(0, 0.02, 16)).astype(np.float32)  # some negative energies
    crop = rng.uniform(-0.2, 1.2, (24, 32, 3)).astype(np.float32)
    rgb = np.array([0.6, 0.55, 0.58], np.float32)
    args = (crop, pred, dist, 1.3, 0.8, rgb, rgb[::-1].copy(), 16)
    crop_t, gt_t, pred_t = tloop.summary_arrays(*args)
    ref = jax.jit(lambda d, i, r: jrender(d[None], i[None], r[None], n=16,
                                          intensity_scale=500.0),
                  compiler_options={"xla_backend_optimization_level": 3})
    for got, (d, i, r) in ((gt_t, (dist, 0.8, rgb[::-1].copy())), (pred_t, (pred, 1.3, rgb))):
        want = np.maximum(np.asarray(ref(d, np.float32(i), r))[0], 0.0)
        assert got.shape == want.shape == (128, 256, 3)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * want.max())
    np.testing.assert_array_equal(crop_t, np.clip(crop, 0, 1))
    assert pred_t.min() == 0.0
    out = tmp_path / "s" / "7.png"
    tloop.render_summary(*args[:-1], 16, str(out))
    from PIL import Image

    with Image.open(out) as im:
        png = np.asarray(im)
    assert png.shape == (256, 768, 3)
    tone = (TONEMAP_VIZ(pred_t)[0] * 255).astype(np.uint8)
    assert abs(float(png[:, 512:].mean()) - float(tone.mean())) < 2.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tloop.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with tloop.profile_trace(None):
        pass
