"""Shared helpers of the tests/test_torch_*.py files: JAX-initialised weights
as NumPy trees, JAX train states to checkpoint, an optax transformation
that captures the JAX steps' gradients, the port's config for a JAX
config, a fixture that runs a
module's torch work on one thread, the NumPy emulation of the tensor-core
kernels' f32 products (3xTF32), and of B6's and B5's U GEMM and gather."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit0
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu_torch import config as tcfg
from emlight_tpu_torch.nn import sphere_conv_kernel as tker
from emlight_tpu_torch.nn import sphere_conv_vjp as tvjp


def randomize_stats(tree, rng):
    """Nontrivial BatchNorm running statistics (fresh ones are 0 / 1)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = randomize_stats(val, rng)
        elif key == "mean":
            out[key] = rng.normal(0, 0.1, val.shape).astype(np.float32)
        else:
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    return out


_INITS: dict = {}


def _arg_key(a):
    """A hashable key of a flax init's arguments (arrays by value)."""
    if isinstance(a, dict):
        return tuple((k, _arg_key(v)) for k, v in sorted(a.items()))
    if isinstance(a, (tuple, list)):
        return tuple(_arg_key(v) for v in a)
    arr = np.asarray(a)
    return arr.shape, str(arr.dtype), arr.tobytes()


@contextlib.contextmanager
def _unwritten():
    """Compiles inside write no executable to the suite's persistent
    compilation cache (tests/conftest.py); see no_persistent_cache_writes."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        yield
    finally:
        jax.config.update(key, old)


def init0(init_fn, *args):
    """R.run_init's job, jitted at XLA opt level 0, and done once per module
    and arguments in a process: create_state built twice with configs that
    differ in the optimizer only (--clip_grad_norm) inits once. The
    variables are JAX arrays, which no caller can change. The compile
    writes no cache entry (a one-off init in any importing module)."""
    key = (repr(init_fn.func.__self__), tuple(sorted(init_fn.keywords.items())), _arg_key(args))
    if key not in _INITS:
        with _unwritten():
            _INITS[key] = jit0(init_fn)(*args)
    return _INITS[key]


@functools.lru_cache(maxsize=None)
def _generator_variables(cfg, seed: int):
    g, _ = P.make_models(cfg)
    env_h, env_w = cfg.crop_size // 2, cfg.crop_size
    guide = jnp.zeros((1, env_h, env_w, 3))
    crop = jnp.zeros((1, cfg.crop_size // 2, cfg.crop_size // 2, 3))
    kg, _ = jax.random.split(jax.random.PRNGKey(seed))
    with _unwritten():
        if cfg.use_vae:
            kg1, kg2 = jax.random.split(kg)
            gv = jit0(lambda a, b: g.init({"params": a, "vae": b}, guide, crop, train=True))(
                kg1, kg2)
        else:
            gv = jit0(lambda k: g.init(k, guide, crop, train=True))(kg)
    return g.apply, jax.tree.map(np.asarray, gv)


def jax_generator_variables(cfg, seed: int):
    """The generator half of P.create_state(PRNGKey(seed), cfg): the same
    model and init call, jitted at XLA opt level 0 (P.create_state inits
    eagerly on the CPU, about 30 s per config, and the discriminator too).
    Returns (g_apply, params, stats) with NumPy leaves and randomized
    BatchNorm running statistics. The init runs once per (cfg, seed) in a
    process; each call returns its own copies."""
    g_apply, gv = _generator_variables(cfg, seed)
    gv = jax.tree.map(np.copy, gv)
    params = gv.pop("params")
    gv["batch_stats"] = randomize_stats(gv["batch_stats"], np.random.default_rng(seed))
    return g_apply, params, gv


def jax_projector_state(cfg, seed: int = 0):
    """P.create_state(PRNGKey(seed), cfg) with its inits jitted at XLA
    opt level 0 (eagerly they take about 30 s at the TINY config), each
    once per process (init0)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "run_init", init0)
        return P.create_state(jax.random.PRNGKey(seed), cfg)


def capture_tx():
    """An optax transformation whose update is zero and whose state is the
    gradient of the last step: the JAX steps' gradients, read exactly."""
    import optax

    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def jax_states(reg_cfg, proj_cfg):
    """R.create_state(PRNGKey(0), reg_cfg) and P.create_state(PRNGKey(1),
    proj_cfg), with the inits jitted at XLA opt level 0 (the JAX package
    runs them eagerly on the CPU: 35 s against 11 s for the ngf-4
    ProjectorState) and every BatchNorm running statistic randomized, the
    regressor's and the generator's (fresh ones are 0 / 1); the generator's
    spectral u and v are the init's random vectors. Each init runs once per
    process (init0)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(R, "run_init", init0)
        reg_state = R.create_state(jax.random.PRNGKey(0), reg_cfg)
        proj_state = P.create_state(jax.random.PRNGKey(1), proj_cfg)
    rng = np.random.default_rng(0)
    reg_state = reg_state.replace(batch_stats=randomize_stats(
        jax.tree.map(np.asarray, reg_state.batch_stats), rng))
    g_stats = jax.tree.map(np.asarray, proj_state.g_stats)
    g_stats["batch_stats"] = randomize_stats(g_stats["batch_stats"], rng)
    return reg_state, proj_state.replace(g_stats=g_stats)


def port_anchor_cfg(a):
    return tcfg.AnchorConfig(**dataclasses.asdict(a))


def port_regression_cfg(cfg):
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("anchors", "sinkhorn")}
    return tcfg.RegressionConfig(anchors=port_anchor_cfg(cfg.anchors),
                                 sinkhorn=tcfg.SinkhornConfig(**dataclasses.asdict(cfg.sinkhorn)),
                                 **fields)


def port_projector_cfg(cfg):
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "anchors"}
    return tcfg.ProjectorConfig(anchors=port_anchor_cfg(cfg.anchors), **fields)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the importing module: its small shapes
    gain nothing from more, and the suite runs several worker processes on
    the same cores, where torch's thread pools contend (measured: a 9-step
    loop of 0.5 s took 75 s with 4 workers). The setting is restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def no_persistent_cache_writes():
    """The importing module writes no executable to the suite's persistent
    compilation cache (tests/conftest.py), and the setting is restored after
    the module. The JAX CLIs compile pipeline_inference at
    tests/test_pipeline.py's config; one such executable, left in the cache
    by tests/test_torch_cli.py, made tests/test_gspmd_isolated.py's
    8-device child stall (XLA:CPU, 2 runs of 2), and the same child passes
    with the cache as it was without that entry (1 run of 1)."""
    with _unwritten():
        yield


def tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return r.astype(np.uint32).view(np.float32)


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernels take an f32 product on the tensor cores: each
    operand split into TF32 hi and lo, lo*hi + hi*lo + hi*hi in f32."""
    ah = tf32(a)
    al = tf32(a - ah)
    bh = tf32(b)
    bl = tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def matmul_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32(a) @ tf32(b)


def tf32_cut(a: np.ndarray) -> np.ndarray:
    """f32 cut to TF32 (10 mantissa bits) toward zero: the bits the tensor
    cores read of a TF32 operand."""
    return (np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_3xtf32_cut(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as B3 and B4 take an f32 product on the tensor cores: each
    operand split as hi = v cut to TF32, lo = v - hi (exact), of which the
    tensor cores read lo cut to TF32; lo*hi + hi*lo + hi*hi in f32."""
    ah = tf32_cut(a)
    al = tf32_cut(a - ah)
    bh = tf32_cut(b)
    bl = tf32_cut(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def u_emulated(g: np.ndarray, k: np.ndarray) -> np.ndarray:
    """U (b, ho, wo, 9, cin) as csrc/sphere_conv_dx_triple.cu's GEMM forms it
    from g (b, ho, wo, cout) and k (3, 3, cin, cout): U[p, (t, c)] = Σ over
    ``triple_tiles``' K splits, in split order, of the split's 16-channel
    steps of g[p] K_t[c]ᵀ in 3xTF32 (operands cut to TF32), each step from
    zero, added in f32."""
    b, ho, wo, cout = g.shape
    cin = k.shape[2]
    plan = tker.triple_tiles(b, ho, wo, cin, cout)
    gf = g.reshape(-1, cout)
    kf = k.reshape(9 * cin, cout)
    u = None
    for z in range(plan.n_split):
        part = np.zeros((gf.shape[0], 9 * cin), np.float32)
        for o0 in range(z * plan.per, min(cout, (z + 1) * plan.per), 16):
            o = slice(o0, min(o0 + 16, cout))
            part = part + matmul_3xtf32_cut(gf[:, o], kf[:, o].T)
        u = part if u is None else u + part
    return u.reshape(b, ho, wo, 9, cin)


def gather_emulated(u: np.ndarray, x_shape, stride: int) -> np.ndarray:
    """dx (b, h, w, cin) as csrc/sphere_conv_dx_triple.cu's gather sums it
    from U: per input row r and column parity p (at stride 1 one, the whole
    row; at stride 2 the columns 2q + p) and live slot m of the row's list
    in slot order (``inverse_tables`` at stride 1, ``parity_tables`` at
    stride 2), dx[r, col] += w0 * U[(out_row, ((col - shift) mod W) /
    stride), tap] in f32, skipped at the dead column."""
    b, h, w, cin = x_shape
    if stride == 1:
        *tabs, _ = tvjp.inverse_tables(h, w, 1)
        tabs = [t[:, None] for t in tabs]
    else:
        *tabs, _ = tker.parity_tables(h, w)
    orow, taps, shifts, w0, jdev = tabs
    dx = np.zeros((b, h, w, cin), np.float32)
    for r in range(h):
        for p in range(stride):
            cols = np.arange(p, w, stride)
            acc = np.zeros((b, len(cols), cin), np.float32)
            for m in range(orow.shape[2]):
                if w0[r, p, m] == 0:
                    continue
                j = (cols - shifts[r, p, m]) % w // stride
                term = u[:, orow[r, p, m], j, taps[r, p, m]] * w0[r, p, m]
                acc = np.where((j != jdev[r, p, m])[None, :, None], acc + term, acc)
            dx[:, r, p::stride] = acc
    return dx


def dx_emulated(g: np.ndarray, k: np.ndarray, x_shape, stride: int) -> np.ndarray:
    """dx as B6 (stride 1) or B5 (stride 2) computes it: ``u_emulated``,
    then ``gather_emulated``."""
    return gather_emulated(u_emulated(g, k), x_shape, stride)
