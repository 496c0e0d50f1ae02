"""One-command checkpoint-parity harness against reference PyTorch weights.

    python -m emlight_tpu_torch.cli.verify_parity --torch_pth latest_net.pth
    python -m emlight_tpu_torch.cli.verify_parity --torch_pth netG.pth --stage generator

Port of emlight_tpu/cli/verify_parity.py: the same flags, stage
auto-detection, report and exit code, plus --device. Loads a reference
checkpoint (RegressionNetwork/train.py:147-167 DenseNet state_dicts, or
GenProjector/util.py:173-179 netG/netD state_dicts), runs the reference math
through the port's own torch oracle (train/torch_ref.py), runs the imported
port model on the same inputs, and prints the max relative error of every
output (logits + reconstructed env maps for the regression stage). Exits
nonzero if any error exceeds --tol (default 1e-3, the BASELINE.md
acceptance bar) — the moment a real Laval `.pth` appears, this is the
acceptance number.

Both run on --device (CUDA by default: the port's generator and
discriminator through the sphere-conv kernels). The oracle runs with TF32
off for cuDNN and matmuls (restored after), so the bar reads the port, not
TF32 rounding in the oracle's grid_sample and convs.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from ..config import AnchorConfig, ProjectorConfig, RegressionConfig
from ..representation.splat import render_anchor_params
from ..train import projector as P
from ..train import regression as R
from ..train import torch_import as TI
from ..train import torch_ref
from ..train.checkpoint import load_checked
from ..train.jax_weights import (densenet_state_from_jax, discriminator_state_from_jax,
                                 generator_state_from_jax)
from ._common import add_device_flag, checked_device


def _detect_stage(sd: dict) -> str:
    if "fc_dist.weight" in sd:
        return "regression"
    if "head_0.conv_0.weight_orig" in sd:
        return "generator"
    if "discriminator_0.model0.0.weight" in sd:
        return "discriminator"
    raise SystemExit(
        "could not auto-detect checkpoint stage from keys "
        f"(got e.g. {sorted(sd)[:5]}); pass --stage explicitly"
    )


def _rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6))


def _load_sd(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    # unwrap common nestings ({'state_dict': ...} / {'model': ...})
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return sd


@contextlib.contextmanager
def _no_tf32():
    """The oracle's run: cuDNN convs and matmuls in full f32."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _oracle(module: torch.nn.Module, sd: dict, dev) -> torch.nn.Module:
    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    return module.eval().to(dev)


def _numpy_sd(sd: dict) -> dict:
    return {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
            for k, v in sd.items()}


def _nchw(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).to(dev)


def _verify_regression(sd, args, dev) -> list[tuple[str, float]]:
    n_anchors = sd["fc_dist.weight"].shape[0]
    growth = sd["features.denseblock1.denselayer1.conv2.weight"].shape[0]
    init = sd["features.conv0.weight"].shape[0]
    n_blocks = sum(1 for k in sd if k.startswith("features.transition")
                   and k.endswith(".conv.weight"))
    block_config = tuple(
        sum(1 for k in sd
            if k.startswith(f"features.denseblock{i}.") and k.endswith(".conv1.weight"))
        for i in range(1, n_blocks + 1)
    )
    model = torch_ref.build_torch_densenet(
        block_config=block_config, growth=growth, init=init,
        n_anchors=n_anchors, pooled_hw=tuple(args.pooled_hw),
    )
    model = _oracle(model, sd, dev)
    print(f"regression checkpoint: anchors={n_anchors} growth={growth} "
          f"init={init} blocks={block_config}")

    ph, pw = args.pooled_hw
    # total downsample: one /2 per transition + the final avg_pool2d(4)
    ds = 4 * (2 ** len(block_config))
    h, w = ph * ds, pw * ds
    x = np.random.default_rng(args.seed).random((args.batch, h, w, 3)).astype(np.float32)
    with torch.no_grad(), _no_tf32():
        ref = model.fwd(_nchw(x, dev))

    params, batch_stats = TI.import_densenet_state_dict(
        _numpy_sd(sd), block_config=block_config, pooled_hw=(ph, pw))
    cfg = RegressionConfig(anchors=AnchorConfig(regression_anchors=n_anchors),
                           crop_h=h, crop_w=w, block_config=block_config,
                           growth_rate=growth, num_init_features=init)
    port = load_checked(R.make_model(cfg, device=dev),
                        densenet_state_from_jax(params, batch_stats), args.torch_pth)
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(dev))
    heads = ("distribution", "intensity", "rgb_ratio", "ambient")
    errs = [(k, _rel_err(out[k].cpu().numpy(), ref[k].cpu().numpy())) for k in heads]

    # reconstructed env maps: render both predictions through the splat
    # rasterizer (RegressionNetwork/train.py:110-145 viz path) and compare
    def render(pred):
        with torch.no_grad():
            return render_anchor_params(
                torch.softmax(pred["distribution"].float(), dim=-1),
                pred["intensity"].float()[:, 0], pred["rgb_ratio"].float(),
                pred["ambient"].float(), n=n_anchors).cpu().numpy()

    errs.append(("env_map", _rel_err(render(out), render(ref))))
    return errs


def _verify_generator(sd, args, dev) -> list[tuple[str, float]]:
    ngf = sd["sphere_conv1.weight"].shape[1]
    tg = _oracle(torch_ref.TGenerator(ngf=ngf, crop_size=args.crop_size), sd, dev)
    print(f"generator checkpoint: ngf={ngf} crop_size={args.crop_size}")

    eh, ew = args.crop_size // 2, args.crop_size
    rng = np.random.default_rng(args.seed)
    guide = rng.random((args.batch, eh, ew, 3)).astype(np.float32)
    crop = rng.random((args.batch, args.crop_size // 2, args.crop_size // 2, 3)).astype(np.float32)
    with torch.no_grad(), _no_tf32():
        ref = tg(_nchw(guide, dev), _nchw(crop, dev)).cpu().numpy()
    del tg

    params, stats = TI.import_generator_state_dict(_numpy_sd(sd), ngf=ngf)
    cfg = ProjectorConfig(ngf=ngf, crop_size=args.crop_size)
    g = load_checked(P.make_models(cfg, device=dev), generator_state_from_jax(params, stats),
                     args.torch_pth)
    with torch.no_grad():
        out = g(torch.from_numpy(guide).to(dev), torch.from_numpy(crop).to(dev))
    return [("env_map", _rel_err(np.transpose(out.cpu().numpy(), (0, 3, 1, 2)), ref))]


def _verify_discriminator(sd, args, dev) -> list[tuple[str, float]]:
    ndf = sd["discriminator_0.model0.0.weight"].shape[0]
    num_d = len({k.split(".")[0] for k in sd if k.startswith("discriminator_")})
    n_layers = max(
        int(k.split(".")[1].removeprefix("model"))
        for k in sd if k.startswith("discriminator_0.model")
    )
    td = _oracle(torch_ref.TMultiscaleD(ndf=ndf, num_d=num_d, n_layers=n_layers, input_nc=6),
                 sd, dev)
    print(f"discriminator checkpoint: ndf={ndf} num_d={num_d} n_layers={n_layers}")

    eh, ew = args.crop_size // 2, args.crop_size
    x = np.random.default_rng(args.seed).random((args.batch, eh, ew, 6)).astype(np.float32)
    with torch.no_grad(), _no_tf32():
        ref = [[f.cpu().numpy() for f in feats] for feats in td(_nchw(x, dev))]
    del td

    params, stats = TI.import_discriminator_state_dict(_numpy_sd(sd), num_d=num_d,
                                                        n_layers=n_layers)
    cfg = ProjectorConfig(ndf=ndf, num_d=num_d, n_layers_d=n_layers)
    d = load_checked(P.make_discriminator(cfg, device=dev),
                     discriminator_state_from_jax(params, stats), args.torch_pth).eval()
    with torch.no_grad():
        out = d(torch.from_numpy(x).to(dev))
    return [
        (f"D{i}_feat{j}", _rel_err(np.transpose(out[i][j].cpu().numpy(), (0, 3, 1, 2)),
                                   ref[i][j]))
        for i in range(num_d) for j in range(n_layers + 1)
    ]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--torch_pth", required=True, help="reference .pth checkpoint")
    ap.add_argument("--stage", default="auto",
                    choices=["auto", "regression", "generator", "discriminator"])
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crop_size", type=int, default=256,
                    help="GenProjector crop_size opt (env maps crop_size/2 x crop_size)")
    ap.add_argument("--pooled_hw", type=int, nargs=2, default=(6, 8),
                    help="regression pooled feature map (6 8 for 192x256 crops)")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    dev = checked_device(ap, argv)
    args = ap.parse_args(argv)

    sd = _load_sd(args.torch_pth)
    stage = _detect_stage(sd) if args.stage == "auto" else args.stage
    errs = {
        "regression": _verify_regression,
        "generator": _verify_generator,
        "discriminator": _verify_discriminator,
    }[stage](sd, args, dev)

    worst = max(e for _, e in errs)
    for name, e in errs:
        marker = "ok " if e <= args.tol else "FAIL"
        print(f"  [{marker}] {name:<14} max rel err {e:.3e}")
    print(f"{stage}: worst {worst:.3e} vs tol {args.tol:g} -> "
          + ("PASS" if worst <= args.tol else "FAIL"))
    return 0 if worst <= args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
