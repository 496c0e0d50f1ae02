"""Omnidirectional-digits demo (the vendored OmniMNIST capability).

Port of emlight_tpu/cli/sphere_demo.py (the reference demo main,
GenProjector/models/networks/spherenet/dataset.py:171-216): project digits
onto the sphere with the same augmentation flags and dump PNGs; --train N
trains the small SphereCNN classifier (SphereConv2D + SphereMaxPool2D) on
the projected digits. The same flags, plus --device: on the card every
sphere conv of a training step runs the hand-written kernels (B1 forward,
B4 dK for both convs, B6 for conv2's dx). PNGs are RGB with the gray value
in each channel.

  python -m emlight_tpu_torch.cli.sphere_demo --idx 0 1 2 --out_dir /tmp/demo
  python -m emlight_tpu_torch.cli.sphere_demo --train 300 --batch 32
  python -m emlight_tpu_torch.cli.sphere_demo --mnist_root /data/mnist --train 300
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.png import write_png
from ..nn.layers import dense
from ..nn.sphere_conv import SphereConv2D, SphereMaxPool2D, sphere_taps
from ..nn.sphere_demo import OmniDigits, load_mnist_idx, synthetic_digits
from ._common import add_device_flag, checked_device

__all__ = ["SphereNet", "train_step", "main"]


class SphereNet(nn.Module):
    """The upstream sphere_cnn example stack: conv -> pool x2, dense head,
    on (B, H, W, 1) maps; the head reads the pooled map flattened in H, W, C
    order, as the JAX model's. Weights from a torch.Generator seeded with
    `seed`."""

    def __init__(self, hw: tuple[int, int], seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = SphereConv2D(1, 32, generator=gen)
        self.pool1 = SphereMaxPool2D(stride=2)
        self.conv2 = SphereConv2D(32, 64, generator=gen)
        self.pool2 = SphereMaxPool2D(stride=2)
        _, _, hw1 = sphere_taps(*hw, 2)
        _, _, (h2, w2) = sphere_taps(*hw1, 2)
        self.fc = dense(h2 * w2 * 64, 10, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool1(F.relu(self.conv1(x)))
        x = self.pool2(F.relu(self.conv2(x)))
        return self.fc(x.reshape(x.shape[0], -1))


def train_step(model: SphereNet, opt: torch.optim.Adam, x: torch.Tensor, y: torch.Tensor):
    """One Adam step on the mean cross-entropy; returns (loss, accuracy) of
    the batch before the update, as tensors on the device."""
    opt.zero_grad(set_to_none=False)
    logits = model(x)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    opt.step()
    return loss.detach(), (logits.detach().argmax(-1) == y).float().mean()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--idx", nargs="+", default=None, help="indices to dump as PNGs")
    ap.add_argument("--out_dir", default="/tmp/sphere_demo")
    ap.add_argument("--mnist_root", default=None,
                    help="directory with MNIST idx(.gz) files; synthetic "
                         "procedural digits when absent")
    ap.add_argument("--fov", type=float, default=120.0)
    ap.add_argument("--outshape", default="60,60")
    ap.add_argument("--flip", action="store_true")
    ap.add_argument("--h_rotate", action="store_true")
    ap.add_argument("--v_rotate", action="store_true")
    ap.add_argument("--fix_aug", action="store_true")
    ap.add_argument("--train", type=int, default=0, metavar="STEPS",
                    help="train the SphereCNN classifier this many steps")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n_synth", type=int, default=2048)
    add_device_flag(ap)
    return ap


def main(argv=None):
    """Run the CLI; with --train returns the last step's accuracy."""
    ap = _parser()
    dev = checked_device(ap, argv)
    args = ap.parse_args(argv)

    if args.mnist_root:
        images, labels = load_mnist_idx(args.mnist_root, train=True)
    else:
        images, labels = synthetic_digits(args.n_synth)
    oh, ow = (int(x) for x in args.outshape.split(","))
    ds = OmniDigits(images, labels, fov=args.fov, outshape=(oh, ow),
                    flip=args.flip, h_rotate=args.h_rotate,
                    v_rotate=args.v_rotate, fix_aug=args.fix_aug, device=dev)

    if args.idx:
        os.makedirs(args.out_dir, exist_ok=True)
        for i in (int(v) for v in args.idx):
            x, label = ds[i]
            path = os.path.join(args.out_dir, f"{i}.png")
            gray = np.clip(x[..., 0], 0, 255).astype(np.uint8)
            write_png(path, np.repeat(gray[..., None], 3, axis=-1))
            print(path, label)

    if args.train:
        model = SphereNet((oh, ow)).to(dev)
        rng = np.random.default_rng(0)
        # the JAX CLI draws its init batch here: the same draw keeps the
        # dataset's augmentation stream in step with it
        ds.batch(range(args.batch))
        opt = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
        for it in range(args.train):
            idx = rng.integers(0, len(ds), args.batch)
            x, y = ds.batch(idx)
            loss, acc = train_step(model, opt, torch.from_numpy(x / 255.0).to(dev),
                                   torch.from_numpy(y).long().to(dev))
            if it % 25 == 0 or it == args.train - 1:
                print(f"step {it}: loss {float(loss):.4f} acc {float(acc):.3f}", flush=True)
        return float(acc)


if __name__ == "__main__":
    main()
