"""The port's checkpoint path (emlight_tpu_torch.core.msgpack,
train/checkpoint.py, train/torch_import.py, the inverse weight maps of
train/jax_weights.py) against flax and the JAX package: real JAX
save_checkpoint files of a RegressionState and a ProjectorState at the
config of tests/test_pipeline.py:25-42 are decoded, restored into the port's
models and run beside the JAX modules they came from."""

import dataclasses
import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from emlight_tpu.config import AnchorConfig, ProjectorConfig, RegressionConfig
from emlight_tpu.train import checkpoint as jckpt
from emlight_tpu.train import projector as P
from emlight_tpu.train import regression as R
from emlight_tpu.train.torch_ref import build_torch_densenet, randomize_densenet
from emlight_tpu_torch.cli._common import load_regressor
from emlight_tpu_torch.core import msgpack as tmsgpack
from emlight_tpu_torch.train import checkpoint as tckpt
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train import regression as TR
from emlight_tpu_torch.train.jax_weights import (
    densenet_state_from_jax,
    densenet_tree_from_state,
    generator_state_from_jax,
    generator_tree_from_state,
)
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


def _cfgs(ngf=4, clip=0.0):
    reg_cfg = dataclasses.replace(
        RegressionConfig(), anchors=AnchorConfig(regression_anchors=N_ANCHORS),
        crop_h=REG_HW[0], crop_w=REG_HW[1], block_config=(2,), clip_grad_norm=clip,
    )
    proj_cfg = dataclasses.replace(
        ProjectorConfig(), crop_size=CROP_SIZE, ngf=ngf, ndf=4,
        anchors=AnchorConfig(n_anchors=N_ANCHORS, env_h=CROP_SIZE // 2, env_w=CROP_SIZE),
    )
    return reg_cfg, proj_cfg


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The JAX states and their files, written by the JAX package's
    save_checkpoint (flax to_bytes)."""
    reg_cfg, proj_cfg = _cfgs()
    reg_state, proj_state = jax_states(reg_cfg, proj_cfg)
    d = tmp_path_factory.mktemp("ckpt")
    reg_path = jckpt.save_checkpoint(str(d / "reg"), reg_state)
    proj_path = jckpt.save_checkpoint(str(d / "proj"), proj_state)
    return reg_cfg, proj_cfg, reg_state, proj_state, reg_path, proj_path


def _assert_same(a, b, path="$"):
    """Equal trees: same keys, types, dtypes, shapes and bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


def _flax_unpackb(data):
    return msgpack.unpackb(data, ext_hook=fs._msgpack_ext_unpack, raw=False)


@pytest.mark.parametrize("which", ["regression", "projector"])
def test_unpackb_matches_msgpack_on_jax_checkpoints(saved, which):
    path = saved[4] if which == "regression" else saved[5]
    with open(path, "rb") as f:
        data = f.read()
    tree = tmsgpack.unpackb(data)
    _assert_same(tree, _flax_unpackb(data))
    expect = (["step", "params", "batch_stats", "opt_state"] if which == "regression" else
              ["step", "g_params", "g_stats", "d_params", "d_stats", "g_opt", "d_opt"])
    assert sorted(tree) == sorted(expect)
    assert isinstance(tree["step"], np.ndarray) and tree["step"].shape == ()
    if which == "projector":
        assert sorted(tree["g_stats"]) == ["batch_stats", "spectral"]
    # arrays are views of the file's bytes, not copies
    leaf = tree["params" if which == "regression" else "g_params"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    assert not leaf.flags.owndata and not leaf.flags.writeable


@pytest.mark.parametrize("which", ["regression", "projector"])
def test_packb_rewrites_the_file_and_flax_reads_it(saved, which):
    path = saved[4] if which == "regression" else saved[5]
    with open(path, "rb") as f:
        data = f.read()
    tree = tckpt.read_checkpoint(path)
    again = tmsgpack.packb(tree)
    assert again == data  # to_bytes' own bytes, key order and encodings included
    _assert_same(fs.msgpack_restore(tmsgpack.packb(tree)), fs.msgpack_restore(data))


def test_every_msgpack_type_decodes_as_msgpack_does():
    """fix/8/16/32 maps, arrays and strs, bin, ext8/16/32 and fixext, ints
    to 64 bits, float32/64, nil, booleans, as msgpack-python writes them."""
    doc = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "é✓"],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
        "map16": {str(i): i for i in range(16)},
        "arr16": list(range(16)),
        "arr32": list(range(70000)),
        "floats": [1.5, -0.0, float("inf")],
        "consts": [None, True, False],
        "exts": [msgpack.ExtType(5, b"x" * n) for n in (1, 2, 4, 8, 16, 3, 255, 256, 70000)],
    }
    doc["map32"] = {str(i): i for i in range(70000)}
    for single in (False, True):
        data = msgpack.packb(doc, use_bin_type=True, use_single_float=single)
        ours = tmsgpack.unpackb(data)
        ref = msgpack.unpackb(data, raw=False, strict_map_key=False)
        exts = ours.pop("exts")
        assert [(e.code, e.data) for e in exts] == [(e.code, e.data) for e in ref.pop("exts")]
        assert ours == ref
    with pytest.raises(tmsgpack.MsgpackError, match="trailing"):
        tmsgpack.unpackb(data + b"\xc0")
    with pytest.raises(tmsgpack.MsgpackError, match="truncated"):
        tmsgpack.unpackb(data[:-3])
    with pytest.raises(tmsgpack.MsgpackError, match="0xc1"):
        tmsgpack.unpackb(b"\xc1")


def test_array_payload_written_as_str_and_scalars():
    """A writer without the bin type (use_bin_type=False) stores the array
    bytes as str8/16/32; ext 3 is a NumPy scalar, ext 2 a complex. The
    port's writer takes dicts of arrays only and refuses scalars."""
    rng = np.random.default_rng(0)
    for n in (7, 300, 20000):  # str8, str16, str32-sized payloads
        arr = rng.random(n).astype(np.float32)
        payload = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes()), use_bin_type=False)
        data = msgpack.packb({"w": msgpack.ExtType(1, payload)}, use_bin_type=False)
        np.testing.assert_array_equal(tmsgpack.unpackb(data)["w"], arr)
        _assert_same(tmsgpack.unpackb(data), fs.msgpack_restore(data))
    tree = {"c": complex(1, -2), "d": np.float64(-1.25), "i": np.int64(7), "s": np.float32(2.5)}
    data = fs.msgpack_serialize(tree)
    _assert_same(tmsgpack.unpackb(data), _flax_unpackb(data))
    for leaf in tree.values():
        with pytest.raises(tmsgpack.MsgpackError, match="cannot serialize"):
            tmsgpack.packb({"x": leaf})
    with pytest.raises(tmsgpack.MsgpackError, match="not a str"):
        tmsgpack.packb({0: np.zeros(2)})


def test_bfloat16_leaves_widen_exactly():
    x = jnp.asarray(np.random.default_rng(1).normal(size=(5, 7)), jnp.bfloat16)
    data = fs.msgpack_serialize({"x": x})
    out = tmsgpack.unpackb(data)["x"]
    assert out.dtype == np.float32 and out.shape == (5, 7)
    np.testing.assert_array_equal(out, np.asarray(x, np.float32))


def test_chunked_arrays_read_and_refused_on_write(monkeypatch):
    """flax's __msgpack_chunked_array__ form (arrays above MAX_CHUNK_SIZE
    bytes), made small here: read what flax writes; the port's writer
    raises rather than write an array above the limit unchunked."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 256)
    tree = {"big": np.random.default_rng(2).random((33, 5)).astype(np.float32),
            "small": np.arange(4, dtype=np.int32)}
    data = fs.msgpack_serialize(dict(tree))
    assert b"__msgpack_chunked_array__" in data
    _assert_same(tmsgpack.msgpack_restore(data), fs.msgpack_restore(data))
    np.testing.assert_array_equal(tmsgpack.msgpack_restore(data)["big"], tree["big"])
    with pytest.raises(tmsgpack.MsgpackError, match="big: 660 bytes.*chunked"):
        tmsgpack.packb(tree)
    small = tmsgpack.unpackb(tmsgpack.packb({"small": tree["small"]}))["small"]
    assert small.tolist() == [0, 1, 2, 3]


def test_inverse_maps_round_trip(saved):
    reg_cfg, proj_cfg, reg_state, proj_state, *_ = saved
    params = jax.tree.map(np.asarray, reg_state.params)
    stats = jax.tree.map(np.asarray, reg_state.batch_stats)
    sd = densenet_state_from_jax(params, stats)
    p2, s2 = densenet_tree_from_state(sd)
    jax.tree.map(np.testing.assert_array_equal, (p2, s2), (params, stats))
    sd2 = densenet_state_from_jax(p2, s2)
    assert list(sd2) == list(sd) and all(torch.equal(sd[k], sd2[k]) for k in sd)

    g_params = jax.tree.map(np.asarray, proj_state.g_params)
    g_stats = jax.tree.map(np.asarray, proj_state.g_stats)
    gsd = generator_state_from_jax(g_params, g_stats)
    gp2, gs2 = generator_tree_from_state(gsd)
    jax.tree.map(np.testing.assert_array_equal, (gp2, gs2), (g_params, g_stats))

    # and from the port's own seeded models
    model = TR.make_model(port_regression_cfg(reg_cfg), device="cpu", seed=3)
    own = model.state_dict()
    back = densenet_state_from_jax(*densenet_tree_from_state(own))
    assert all(torch.equal(own[k], back[k]) for k in own)
    gen = TP.make_models(port_projector_cfg(proj_cfg), device="cpu", seed=4)
    gown = gen.state_dict()
    gback = generator_state_from_jax(*generator_tree_from_state(gown))
    assert set(gback) == set(gown)
    assert all(torch.equal(gown[k], gback[k]) for k in gown)


def test_save_checkpoint_port_trees(saved, tmp_path):
    """The port writes a JAX-layout checkpoint of its seeded models that the
    restore reads back bit for bit; flax reads the same file; no temporary
    file stays behind."""
    reg_cfg, proj_cfg, *_ = saved
    gen = TP.make_models(port_projector_cfg(proj_cfg), device="cpu", seed=5)
    params, stats = generator_tree_from_state(gen.state_dict())
    path = tckpt.save_checkpoint(str(tmp_path / "c"), {
        "step": np.zeros((), np.int32), "g_params": params, "g_stats": stats})
    assert os.listdir(tmp_path / "c") == ["latest.msgpack"]
    assert path == str(tmp_path / "c" / "latest.msgpack")
    other = tckpt.restore_generator(path, TP.make_models(port_projector_cfg(proj_cfg),
                                                         device="cpu", seed=6))
    for k, v in gen.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    with open(path, "rb") as f:
        flax_tree = fs.msgpack_restore(f.read())
    jax.tree.map(np.testing.assert_array_equal, flax_tree["g_params"], params)


def test_restore_regressor_matches_jax(saved):
    reg_cfg, _, reg_state, _, reg_path, _ = saved
    model = tckpt.restore_regressor(
        reg_path, TR.make_model(port_regression_cfg(reg_cfg), device="cpu", seed=9))
    crop = np.random.default_rng(5).random((2, *REG_HW, 3), dtype=np.float32)
    ref = R.predict(reg_state.apply_fn, reg_state.params, reg_state.batch_stats, crop)
    out = TR.predict(model, torch.from_numpy(crop))
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_restore_ignores_the_optimizer_state(saved, tmp_path):
    """A state trained with --clip_grad_norm has another opt_state
    structure; the regressor loads from it all the same."""
    reg_cfg, _, reg_state, *_ = saved
    clipped = R.create_state(jax.random.PRNGKey(0), dataclasses.replace(reg_cfg,
                                                                        clip_grad_norm=1.0))
    clipped = clipped.replace(params=reg_state.params, batch_stats=reg_state.batch_stats)
    assert (jax.tree.structure(clipped.opt_state)
            != jax.tree.structure(reg_state.opt_state))
    path = jckpt.save_checkpoint(str(tmp_path / "clip"), clipped)
    a = tckpt.restore_regressor(path, TR.make_model(port_regression_cfg(reg_cfg), device="cpu"))
    b = tckpt.restore_regressor(saved[4], TR.make_model(port_regression_cfg(reg_cfg),
                                                        device="cpu", seed=1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def test_restore_generator_matches_jax(saved):
    _, proj_cfg, _, proj_state, _, proj_path = saved
    gen = tckpt.restore_generator(
        proj_path, TP.make_models(port_projector_cfg(proj_cfg), device="cpu", seed=9))
    rng = np.random.default_rng(6)
    b = 2
    dist = rng.gamma(0.3, 1.0, (b, N_ANCHORS)).astype(np.float32)
    batch = {
        "distribution": dist / dist.sum(1, keepdims=True),
        "intensity": rng.uniform(1, 50, b).astype(np.float32),
        "rgb_ratio": rng.uniform(0.3, 0.8, (b, 3)).astype(np.float32),
        "ambient": rng.uniform(0, 0.05, (b, 3)).astype(np.float32),
        "alpha": rng.uniform(0.5, 2.0, b).astype(np.float32),
        "crop": rng.random((b, CROP_SIZE // 2, CROP_SIZE // 2, 3), dtype=np.float32),
    }
    ref = np.asarray(P.inference(proj_state, batch, proj_cfg))
    out = TP.inference(gen, {k: torch.from_numpy(v) for k, v in batch.items()},
                       port_projector_cfg(proj_cfg)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-4)


def test_reference_pth_import_matches_torch(tmp_path):
    """A reference-named torch DenseNet saved as .pth, read by the port's
    regressor loader at a crop whose pooled map is not the default 6x8
    (96x128 at one block: 12x16), against the torch model's own outputs at
    tests/test_torch_import.py's bar."""
    reg_cfg = dataclasses.replace(
        RegressionConfig(), anchors=AnchorConfig(regression_anchors=N_ANCHORS),
        crop_h=96, crop_w=128, block_config=(2,))
    torch_model = build_torch_densenet(block_config=(2,), n_anchors=N_ANCHORS,
                                       pooled_hw=(12, 16))
    randomize_densenet(torch_model, seed=2)
    torch_model.eval()
    path = str(tmp_path / "latest_net.pth")
    torch.save(torch_model.state_dict(), path)
    model = load_regressor(path, port_regression_cfg(reg_cfg), "cpu")
    x = np.random.default_rng(7).random((2, 96, 128, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_model.fwd(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))))
    out = TR.predict(model, torch.from_numpy(x))
    for k in ref:
        r, o = ref[k].numpy(), out[k].numpy()
        rel = np.abs(o - r).max() / max(np.abs(r).max(), 1e-6)
        assert rel < 1e-3, f"{k}: rel err {rel}"


def test_size_mismatch_names_the_leaf(saved):
    """An ngf-4 checkpoint loaded into an ngf-8 generator, and a 16-anchor
    regressor into a 96-anchor one, raise ValueError with the entry's name
    and both shapes."""
    reg_cfg, proj_cfg, *_, reg_path, proj_path = saved
    wide = TP.make_models(port_projector_cfg(_cfgs(ngf=8)[1]), device="cpu")
    with pytest.raises(ValueError, match=r"at netE\.layer1\.weight: model \(8, 3, 3, 3\) vs "
                                         r"checkpoint \(4, 3, 3, 3\)"):
        tckpt.restore_generator(proj_path, wide)
    more = TR.make_model(port_regression_cfg(dataclasses.replace(
        reg_cfg, anchors=AnchorConfig(regression_anchors=96))), device="cpu")
    with pytest.raises(ValueError, match=r"at fc_dist\.weight: model \(96, 1024\) vs "
                                         r"checkpoint \(16, 1024\)"):
        tckpt.restore_regressor(reg_path, more)
