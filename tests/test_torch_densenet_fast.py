"""The port's concat-free DenseNet forwards (emlight_tpu_torch.nn.densenet_fast),
BN folding, the regressor's bf16 compute and remat, against the JAX
package's (emlight_tpu/nn/densenet_fast.py, nn/densenet.py), at the bars of
tests/test_densenet_fast.py, tests/test_fold_bn.py and
tests/test_torch_regression_train.py.

The same variables (a JAX init at blocks (3, 2), crop 64x64, with
randomized running statistics) go through both packages by the weight
bridge. JAX's fast_apply, buffer_apply and train_apply reach no Pallas
kernel; the port's reach the dense-layer conv wrappers, which take their
plain versions on the CPU."""

import copy
import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import jit0
from emlight_tpu.config import AnchorConfig, RegressionConfig
from emlight_tpu.nn import densenet as jdn
from emlight_tpu.nn import densenet_fast as jdf
from emlight_tpu.train import regression as R
from emlight_tpu.train.data import synthetic_regression_batch as j_batch
from emlight_tpu_torch.nn import densenet_fast as DF
from emlight_tpu_torch.nn.densenet import DenseNet, fold_eval_variables
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.jax_weights import (densenet_grads_from_jax, densenet_state_from_jax,
                                                 densenet_tree_from_state)
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    no_persistent_cache_writes,
    one_torch_thread,
    port_regression_cfg,
    randomize_stats,
)

BLOCKS = (3, 2)
HW = (64, 64)
N_ANCHORS = 16
HEADS = ("distribution", "intensity", "rgb_ratio", "ambient")
F32_BAR = dict(rtol=1e-4, atol=1e-4)  # tests/test_densenet_fast.py, f32
BF16_REL = 0.02                        # and its bf16 bar, of each head's scale
# tests/test_torch_regression_train.py's bars
STATE_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_REL, GRAD_FLOOR = 2e-4, 1e-2


def _x64():
    from jax._src.config import enable_x64  # as tests/test_densenet_fast.py does

    return enable_x64(True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def variables():
    """JAX DenseNet variables (params, randomized batch_stats) and a crop."""
    model = jdn.DenseNet(block_config=BLOCKS, n_anchors=N_ANCHORS)
    x = np.random.default_rng(0).random((2, *HW, 3), dtype=np.float32)
    v = jit0(lambda xx: model.init(jax.random.PRNGKey(0), xx, train=True))(x)
    stats = randomize_stats(_np(v["batch_stats"]), np.random.default_rng(1))
    return _np(v["params"]), stats, x


def _port(params, stats, dtype=torch.float32):
    m = DenseNet(block_config=BLOCKS, n_anchors=N_ANCHORS, input_hw=HW, dtype=dtype)
    m.load_state_dict(densenet_state_from_jax(params, stats))
    return m.eval()


def _heads(out):
    return {k: np.asarray(out[k], np.float32) for k in HEADS}


def _assert_bf16(got, ref):
    for k in HEADS:
        err = np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
        assert err < BF16_REL, (k, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_buffer_apply_matches_jax(variables, dtype):
    params, stats, x = variables
    ref = _heads(jit0(lambda p, s, xx: jdf.buffer_apply(
        p, s, xx, block_config=BLOCKS, dtype=jnp.dtype(dtype)))(params, stats, x))
    got = _heads(DF.buffer_apply(_port(params, stats, getattr(torch, dtype)),
                                 torch.from_numpy(x)))
    if dtype == "float32":
        for k in HEADS:
            np.testing.assert_allclose(got[k], ref[k], **F32_BAR, err_msg=k)
    else:
        _assert_bf16(got, ref)


@pytest.mark.parametrize("dtype,group", [("float32", 1), ("float32", 3), ("float32", 4),
                                         ("bfloat16", 4)])
def test_fast_apply_matches_jax(variables, dtype, group):
    """group 3 leaves an uncompacted tail at a block's end; 4 does not."""
    params, stats, x = variables
    ref = _heads(jit0(lambda p, s, xx: jdf.fast_apply(
        p, s, xx, block_config=BLOCKS, dtype=jnp.dtype(dtype), group=group))(params, stats, x))
    got = _heads(DF.fast_apply(_port(params, stats, getattr(torch, dtype)),
                               torch.from_numpy(x), group=group))
    if dtype == "float32":
        for k in HEADS:
            np.testing.assert_allclose(got[k], ref[k], **F32_BAR, err_msg=k)
    else:
        _assert_bf16(got, ref)


def test_standard_bf16_eval_matches_jax(variables):
    """The DenseNet module's own forward in bf16 (flax's dtype flow) against
    DenseNet(dtype=bfloat16).apply."""
    params, stats, x = variables
    model = jdn.DenseNet(block_config=BLOCKS, n_anchors=N_ANCHORS, dtype=jnp.bfloat16)
    ref = _heads(jit0(lambda v, xx: model.apply(v, xx, train=False))(
        {"params": params, "batch_stats": stats}, x))
    port = _port(params, stats, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = _heads(TR.predict(port, torch.from_numpy(x)))
    _assert_bf16(got, ref)


def test_baked_infer_equals_eval_apply_bit_for_bit(variables):
    params, stats, x = variables
    cfg = port_regression_cfg(dataclasses.replace(
        RegressionConfig(), crop_h=HW[0], crop_w=HW[1], block_config=BLOCKS,
        anchors=AnchorConfig(regression_anchors=N_ANCHORS)))
    model = _port(params, stats)
    crop = torch.from_numpy(x)
    baked = TR.make_baked_infer(cfg, model)(crop)
    ev = TR.predict(model, crop, TR.make_eval_apply(cfg))
    for k in HEADS:
        assert torch.equal(baked[k], ev[k]), k
    with pytest.raises(ValueError, match="eval-only"):
        TR.make_eval_apply(cfg)(model, crop, train=True)


def test_fold_eval_variables_matches_jax(variables):
    """The folded tree against JAX's fold_eval_variables, a tiny-|a| channel
    included (its kernel column and pad zeroed), both ways through the
    bridge; the folded model's heads against JAX's folded DenseNet at
    tests/test_fold_bn.py's bar."""
    params, stats, x = variables
    params = copy.deepcopy(params)
    params["denseblock1_denselayer2"]["norm2"]["scale"][5] = 1e-20  # |a| ~ 0
    jp, js = jdn.fold_eval_variables(params, stats)
    jp, js = _np(jp), _np(js)
    folded = fold_eval_variables(_port(params, stats).state_dict())
    ref = densenet_state_from_jax(jp, js)
    assert set(folded) == set(ref)
    for k in ref:
        torch.testing.assert_close(folded[k], ref[k], rtol=1e-6, atol=1e-7, msg=k)
    pad = folded["denseblock1_denselayer2.conv2_pad"]
    assert pad[5] == 0 and torch.all(folded["denseblock1_denselayer2.conv2.weight"][:, 5] == 0)
    tp, ts = densenet_tree_from_state(folded)
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    assert jax.tree.structure(ts) == jax.tree.structure(js)

    fmodel = jdn.DenseNet(block_config=BLOCKS, n_anchors=N_ANCHORS, fold_bn=True)
    want = _heads(jit0(lambda v, xx: fmodel.apply(v, xx, train=False))(
        {"params": jp, "batch_stats": js}, x))
    cfg = port_regression_cfg(dataclasses.replace(
        RegressionConfig(), crop_h=HW[0], crop_w=HW[1], block_config=BLOCKS,
        anchors=AnchorConfig(regression_anchors=N_ANCHORS)))
    port_folded = TR.fold_for_inference(cfg, _port(params, stats))
    got = _heads(TR.predict(port_folded, torch.from_numpy(x)))
    for k in HEADS:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)


def _jax_train(params, stats, x, dtype):
    """JAX train_apply's heads, new batch stats and the gradient of
    sum(heads²) in every parameter, as NumPy trees."""
    def loss(p):
        heads, new = jdf.train_apply(p, stats, x, block_config=BLOCKS, dtype=dtype)
        return sum(jnp.sum(h ** 2) for h in heads.values()), (heads, new)

    (_, (heads, new)), grads = jit0(jax.value_and_grad(loss, has_aux=True))(params)
    return _np(heads), _np(new), _np(grads)


def _port_train(model, x, **kw):
    heads = DF.train_apply(model, torch.from_numpy(x), **kw)
    sum(torch.sum(h ** 2) for h in heads.values()).backward()
    return ({k: v.detach().numpy() for k, v in heads.items()}, model.state_dict(),
            {n: p.grad for n, p in model.named_parameters()})


def _running(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_train_apply_matches_jax_f32(variables):
    """Heads, the running statistics after the step and every gradient leaf
    of sum(heads²), at tests/test_torch_regression_train.py's bars."""
    params, stats, x = variables
    ref_h, ref_s, ref_g = _jax_train(params, stats, x, jnp.float32)
    ref_s = densenet_state_from_jax(params, ref_s)
    ref_g = densenet_grads_from_jax(ref_g)
    got_h, got_s, got_g = _port_train(_port(params, stats), x)
    for k in HEADS:
        np.testing.assert_allclose(got_h[k], ref_h[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k, r in _running(ref_s).items():
        torch.testing.assert_close(got_s[k], r, **STATE_TOL, msg=k)
    scale = max(r.abs().max().item() for r in ref_g.values())
    assert set(got_g) == set(ref_g)
    for name, r in ref_g.items():
        err = (got_g[name] - r).abs().max().item()
        assert err <= GRAD_REL * max(r.abs().max().item(), GRAD_FLOOR * scale), (name, err)


def test_train_apply_matches_jax_f64(variables):
    """In f64, where the plain versions compute in f64: heads and
    statistics at tests/test_densenet_fast.py's 1e-10. Gradients within
    2e-7 of the largest: both packages round the features to f32 before the
    heads (the JAX package's DenseNet does, in f64 too), so the cotangent
    there is rounded to f32 on its way back, each head's apart and then
    summed in f32 (nn/densenet.py::heads_f32; until the port cast per head
    it summed first and sat 6.0e-8 from JAX, one f32 rounding, measured).
    Compared as JAX-layout f64 trees (the bridge's state dicts are f32)."""
    params, stats, x = variables
    p64 = jax.tree.map(lambda a: a.astype(np.float64), params)
    # statistics away from 0 / 1, exact in f32 so the bridge carries them
    s64 = jax.tree.map(lambda a: (a + np.float32(0.13)).astype(np.float64), stats)
    x64 = np.random.default_rng(3).standard_normal(x.shape)
    with _x64():
        ref_h, ref_s, ref_g = _jax_train(p64, s64, x64, jnp.float64)
    model = DenseNet(block_config=BLOCKS, n_anchors=N_ANCHORS, input_hw=HW,
                     dtype=torch.float64).double()
    model.load_state_dict(densenet_state_from_jax(p64, s64))
    got_h, got_s, got_g = _port_train(model, x64)
    for k in HEADS:
        np.testing.assert_allclose(got_h[k], ref_h[k], rtol=1e-10, atol=1e-10, err_msg=k)
    _, got_s = densenet_tree_from_state(got_s)
    got_g, _ = densenet_tree_from_state(got_g)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got_s)[0],
                            jax.tree.leaves(ref_s)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12, err_msg=str(path))
    assert jax.tree.structure(got_g) == jax.tree.structure(ref_g)
    gmax = max(np.abs(r).max() for r in jax.tree.leaves(ref_g))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got_g)[0],
                            jax.tree.leaves(ref_g)):
        assert np.abs(a - b).max() < 2e-7 * gmax, path


def test_block_vjp_equals_plain_autograd():
    """The dense block's structured backward against plain autograd through
    the out-of-place loop (block_vjp=False), f64: heads, statistics and
    gradients to rounding."""
    torch.manual_seed(0)
    base = DenseNet(block_config=BLOCKS, n_anchors=N_ANCHORS, input_hw=HW,
                    num_init_features=8, growth_rate=6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2)).double()
    x = np.random.default_rng(4).standard_normal((3, *HW, 3))
    out = {}
    for vjp in (True, False):
        out[vjp] = _port_train(copy.deepcopy(base), x, block_vjp=vjp)
    for a, b in zip(out[True], out[False]):
        for k in a:
            ta, tb = torch.as_tensor(a[k]), torch.as_tensor(b[k])
            torch.testing.assert_close(ta, tb, rtol=1e-11, atol=1e-12, msg=k)


def test_remat_gradients_equal_the_gradients_without():
    """--remat recomputes each dense layer in the standard train forward's
    backward: the same gradients and running statistics, updated once."""
    cfg = port_regression_cfg(dataclasses.replace(
        RegressionConfig(), crop_h=HW[0], crop_w=HW[1], block_config=BLOCKS,
        train_forward="standard"))
    batch = j_batch(2, 96, HW, seed=5)
    got = {}
    for remat in (False, True):
        st = TR.create_state(dataclasses.replace(cfg, remat=remat), device="cpu", seed=1)
        assert st.apply_fn is TR.standard_apply
        metrics = TR.train_step(st, batch)
        got[remat] = (metrics, {n: p.grad for n, p in st.model.named_parameters()},
                      st.model.state_dict())
    for a, b in zip(got[False], got[True]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_train_forward_picks_the_forward():
    """create_state honours train_forward: "buffer" (the default) runs the
    buffer forward, "standard" the module's; one step from one state agrees
    at tests/test_torch_regression_train.py's loss bar."""
    cfg = port_regression_cfg(dataclasses.replace(
        RegressionConfig(), crop_h=HW[0], crop_w=HW[1], block_config=BLOCKS))
    batch = j_batch(2, 96, HW, seed=6)
    losses = {}
    for tf in ("buffer", "standard"):
        st = TR.create_state(dataclasses.replace(cfg, train_forward=tf), device="cpu", seed=2)
        assert (st.apply_fn is TR.standard_apply) == (tf == "standard")
        losses[tf] = {k: v.item() for k, v in TR.train_step(st, batch).items()}
    for k, v in losses["standard"].items():
        np.testing.assert_allclose(losses["buffer"][k], v, rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="train_forward"):
        TR.create_state(dataclasses.replace(cfg, train_forward="fast"), device="cpu")


def test_bf16_train_step_losses_match_jax():
    """One train_step in bf16 (the buffer forward, both sides) from the same
    state and batch: every loss term within bf16's 0.02 relative."""
    small = dataclasses.replace(RegressionConfig(), crop_h=HW[0], crop_w=HW[1], batch_size=2,
                                block_config=(2, 2), dtype="bfloat16")
    batch = j_batch(2, 96, HW, seed=3)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "run_init", lambda init_fn, *args: jit0(init_fn)(*args))
        s0 = R.create_state(jax.random.PRNGKey(0), small)
    tx = optax.adam(small.lr)
    s0 = s0.replace(batch_stats=randomize_stats(_np(s0.batch_stats), np.random.default_rng(1)),
                    tx=tx, opt_state=tx.init(s0.params))
    _, ref = R.train_step(s0, {k: jnp.asarray(v) for k, v in batch.items()}, small)
    state = TR.create_state(port_regression_cfg(small), device="cpu")
    state.model.load_state_dict(densenet_state_from_jax(_np(s0.params), s0.batch_stats))
    got = TR.train_step(state, batch)
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(ref[k]), rtol=BF16_REL, err_msg=k)


def test_new_modules_import_nothing_of_jax():
    """The modules this slice adds, and the package around them, import
    nothing of JAX or the JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("nn.densenet_fast", "representation.extract", "cli.extract_distribution",
                     "train.regression", "train.pipeline", "native", "core.geometry"):
            importlib.import_module("emlight_tpu_torch." + name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "emlight_tpu"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
