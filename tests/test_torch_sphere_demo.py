"""The port's OmniMNIST demo pieces (nn/sphere_demo.py, nn/sphere_conv.py's
sphere_gather and SphereMaxPool2D, cli/sphere_demo.py's SphereNet step)
against the JAX package's, on the CPU, at tests/test_sphere_demo.py's sizes
(24x24 and 16x16 maps, batch 8)."""

import functools
import gzip
import struct

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emlight_tpu.core.geometry import equirect_xyz_splat
from emlight_tpu.nn import sphere_conv as jsc
from emlight_tpu.nn import sphere_demo as jdemo
from emlight_tpu_torch.cli.sphere_demo import SphereNet, train_step
from emlight_tpu_torch.nn import sphere_conv as tsc
from emlight_tpu_torch.nn import sphere_demo as tdemo
from emlight_tpu_torch.train.jax_weights import spherenet_state_from_jax
from torch_port_helpers import init0, no_persistent_cache_writes, one_torch_thread  # noqa: F401

# a pixel may differ beyond 1e-3 (of 0-255) only where the JAX ray meets the
# tangent square within EDGE of its border: there an ulp of the rotated ray
# decides whether the pixel is inside the FOV
EDGE = 1e-6
GRAD_REL, GRAD_FLOOR, GRAD_SPREAD, JITTER = 2e-4, 1e-2, 4.0, 1e-6
LR = 1e-3  # the demo's default


def _jax_uv(v_rot, out_hw, fov=120.0):
    """The JAX projection's tangent-plane (u, v) of every ray, h_rot 0
    (emlight_tpu/nn/sphere_demo.py:46-59)."""
    grid = jnp.asarray(equirect_xyz_splat(*out_hw), jnp.float32)
    out = []
    for vr in np.asarray(v_rot, np.float32):
        cv, sv = jnp.cos(vr), jnp.sin(vr)
        rot_v = jnp.array([[cv, 0, sv], [0, 1, 0], [-sv, 0, cv]])
        rays = grid.reshape(-1, 3) @ (jnp.eye(3) @ rot_v)
        z = rays[:, 0]
        scale = jnp.tan(jnp.deg2rad(fov / 2.0))
        u = jnp.where(z > 1e-6, rays[:, 1] / jnp.maximum(z, 1e-6), 2.0) / scale
        v = jnp.where(z > 1e-6, rays[:, 2] / jnp.maximum(z, 1e-6), 2.0) / scale
        out.append(np.stack([np.asarray(u), np.asarray(v)], -1).reshape(*out_hw, 2))
    return np.stack(out)


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("outshape", [(24, 24), (16, 32)])
def test_omni_digits_match_jax(aug, outshape):
    """Batches with fix_aug (flip, h_rotate, v_rotate) or plain: the same
    labels, the same NumPy draws, maps within 1e-3 of the 0-255 scale."""
    imgs, labels = jdemo.synthetic_digits(32)
    t_imgs, t_labels = tdemo.synthetic_digits(32)
    np.testing.assert_array_equal(t_imgs, imgs)
    np.testing.assert_array_equal(t_labels, labels)
    kw = dict(outshape=outshape, flip=aug, h_rotate=aug, v_rotate=aug, fix_aug=aug)
    jds = jdemo.OmniDigits(imgs, labels, **kw)
    tds = tdemo.OmniDigits(imgs, labels, device="cpu", **kw)
    if aug:
        for k in ("flip", "h", "v"):
            np.testing.assert_array_equal(tds.aug[k], jds.aug[k])
    for idx in (range(8), [3, 31, 0, 17]):
        x, y = jds.batch(idx)
        tx, ty = tds.batch(idx)
        np.testing.assert_array_equal(ty, y)
        assert tx.shape == x.shape == (len(y), *outshape, 1) and tx.dtype == np.float32
        bad = np.abs(tx - x) > 1e-3
        if bad.any():  # only on the FOV edge, before the flip and the roll
            assert not aug, "an edge pixel under augmentation: undo the flip and roll first"
            uv = _jax_uv(np.zeros(len(y)), outshape)
            edge = np.abs(np.abs(uv) - 1).min(-1) <= EDGE
            assert edge[bad[..., 0]].all()
    assert (x == 0).mean() > 0.2 and x.max() > 100  # tests/test_sphere_demo.py's checks


def test_project_to_sphere_one_rotation_per_sample():
    rng = np.random.default_rng(4)
    img = rng.random((3, 12, 10, 2)).astype(np.float32) * 255
    v_rot = np.array([0.0, 0.4, -1.1], np.float32)
    h_rot = np.array([0.0, -0.7, 2.0], np.float32)
    ref = np.asarray(jdemo.project_to_sphere(jnp.asarray(img), jnp.asarray(v_rot),
                                             jnp.asarray(h_rot), out_h=20, out_w=40))
    got = tdemo.project_to_sphere(torch.from_numpy(img), torch.from_numpy(v_rot),
                                  torch.from_numpy(h_rot), out_h=20, out_w=40).numpy()
    assert np.abs(got - ref).max() <= 1e-3


def test_load_mnist_idx(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 5, dtype=np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    got = tdemo.load_mnist_idx(str(tmp_path), train=False)
    ref = jdemo.load_mnist_idx(str(tmp_path), train=False)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(FileNotFoundError):
        tdemo.load_mnist_idx(str(tmp_path), train=True)


@pytest.mark.parametrize("stride", [1, 2])
def test_sphere_gather_and_max_pool_match_jax(stride):
    """sphere_gather bit for bit; SphereMaxPool2D's forward and gradient
    within 1e-6 of the largest value."""
    x = np.random.default_rng(stride).standard_normal((2, 16, 16, 5)).astype(np.float32)
    np.testing.assert_array_equal(tsc.sphere_gather(torch.from_numpy(x), stride).numpy(),
                                  np.asarray(jsc.sphere_gather(jnp.asarray(x), stride)))
    np.testing.assert_array_equal(tsc.sphere_gather(torch.from_numpy(x), stride, tap=4).numpy(),
                                  np.asarray(jsc.sphere_gather(jnp.asarray(x), stride, tap=4)))
    g = np.random.default_rng(9).standard_normal((2, 16 // stride, 16 // stride, 5))

    def jloss(a):
        return (jsc.SphereMaxPool2D(stride=stride).apply({}, a) * g).sum()

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tsc.SphereMaxPool2D(stride)(xt)
    assert out.shape == (2, 16 // stride, 16 // stride, 5)
    (out.double() * torch.from_numpy(g)).sum().backward()
    pooled = np.asarray(jsc.SphereMaxPool2D(stride=stride).apply({}, jnp.asarray(x)))
    assert np.abs(out.detach().numpy() - pooled).max() <= 1e-6 * np.abs(pooled).max()
    ref_grad = np.asarray(ref_grad)
    assert np.abs(xt.grad.numpy() - ref_grad).max() <= 1e-6 * np.abs(ref_grad).max()


class _JaxSphereNet(fnn.Module):
    """emlight_tpu/cli/sphere_demo.py:75-83's model (defined inside its main)."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(jsc.SphereConv2D(32, name="conv1")(x))
        x = jsc.SphereMaxPool2D(stride=2, name="pool1")(x)
        x = fnn.relu(jsc.SphereConv2D(64, name="conv2")(x))
        x = jsc.SphereMaxPool2D(stride=2, name="pool2")(x)
        return fnn.Dense(10, name="fc")(x.reshape(x.shape[0], -1))


def test_spherenet_step_matches_jax():
    """One training step with the JAX model's initial params carried across:
    the loss at 1e-5, every gradient leaf within GRAD_REL of its own largest
    magnitude (floored at GRAD_FLOOR of the model's largest) or, where
    larger, GRAD_SPREAD times the JAX gradient's change under a JITTER
    relative perturbation of the batch; then the Adam update moves the
    port's parameters as optax.adam moves the JAX ones: 99 % of the
    elements within 1e-5 of the larger of the leaf's scale and lr, every
    element within two Adam steps of opposite sign (2 lr) of it, where a
    gradient element's sign is rounding noise (as in
    tests/test_torch_train_state.py)."""
    imgs, labels = jdemo.synthetic_digits(64)
    ds = jdemo.OmniDigits(imgs, labels, outshape=(16, 16))
    x, y = ds.batch(range(8))
    x = (x / 255.0).astype(np.float32)
    model = _JaxSphereNet()
    params = jax.tree.map(np.asarray, init0(functools.partial(model.init),
                                            jax.random.PRNGKey(0), jnp.asarray(x)))

    def loss_fn(p, a):
        logits = model.apply(p, a)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    vg = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = vg(params, jnp.asarray(x))
    xj = (x * (1 + JITTER * np.random.default_rng(1).standard_normal(x.shape))).astype(np.float32)
    _, grads_j = vg(params, jnp.asarray(xj))
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(params))
    new_params = optax.apply_updates(params, updates)

    net = SphereNet((16, 16))
    net.load_state_dict(spherenet_state_from_jax(params["params"]), strict=True)
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    t_loss, acc = train_step(net, opt, torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    assert 0.0 <= acc.item() <= 1.0

    t_grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    ref = {k: v.numpy() for k, v in spherenet_state_from_jax(grads["params"]).items()}
    jit = {k: v.numpy() for k, v in spherenet_state_from_jax(grads_j["params"]).items()}
    assert set(t_grads) == set(ref) == {"conv1.kernel", "conv1.bias", "conv2.kernel",
                                        "conv2.bias", "fc.weight", "fc.bias"}
    scale = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        floor = max(np.abs(r).max(), GRAD_FLOOR * scale)
        bar = max(GRAD_REL, GRAD_SPREAD * np.abs(jit[k] - r).max() / floor)
        assert np.abs(t_grads[k] - r).max() <= bar * floor, (k, bar)
    moved = {k: v.numpy() for k, v in spherenet_state_from_jax(new_params["params"]).items()}
    for k, p in net.named_parameters():
        d, tol = np.abs(p.detach().numpy() - moved[k]), 1e-5 * max(np.abs(moved[k]).max(), LR)
        assert d.max() <= tol + 2 * LR, k
        assert (d <= tol).mean() > 0.99, k
