"""Run chip_smoke.py's phase 16d (tensor-parallel serving, run_auto) and
phase 16e (tensor-parallel training, run_auto_train) alone.

    python scripts/chip_auto.py [--seed 0] [--phase 16d|16e|both] [--out FILE]

Builds the kernels; for 16d the main path's seeded models
(RegressionConfig() and ProjectorConfig(), chip_smoke.py's seeds) and
phase 4's first request of 8 crops, then runs run_auto: dp1 x tp2 over
NCCL on two cards (else two ranks sharing card 0 over gloo) and dp2 x tp2
over NCCL where there are four cards; for 16e run_auto_train on the same
grids, then fullsize_check (--devices 1 --tp 1, and --devices 4 --tp 2
with four cards). Use it for the NCCL grids on a host with four cards
without the rest of chip_smoke.py. Prints the card, the phases' lines and
one JSON line of their results; --out writes them, the per-shape rows
included. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=("16d", "16e", "both"), default="16d")
    ap.add_argument("--out", default=None, help="write the phases' results here as JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_auto: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from emlight_tpu_torch import kernels
    from emlight_tpu_torch.config import ProjectorConfig, RegressionConfig
    from emlight_tpu_torch.train import projector as PJ
    from emlight_tpu_torch.train import regression as RG

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    C.log(f"[device] {torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    kernels.build()
    reg_cfg, proj_cfg = RegressionConfig(), ProjectorConfig()
    regressor = RG.make_model(reg_cfg, device=dev, seed=args.seed)
    generator = PJ.make_models(proj_cfg, device=dev, seed=args.seed + 1)
    rng = np.random.default_rng(args.seed)

    def crops(b):  # chip_smoke.py main's draws, in its order
        crop_reg = rng.random((b, reg_cfg.crop_h, reg_cfg.crop_w, 3), dtype=np.float32)
        crop_proj = rng.random((b, proj_cfg.crop_size // 2, proj_cfg.crop_size // 2, 3),
                               dtype=np.float32)
        return torch.from_numpy(crop_reg).to(dev), torch.from_numpy(crop_proj).to(dev)

    crops(1)  # main's warm-up request
    out = {}
    if args.phase in ("16d", "both"):
        out["auto"] = C.run_auto(torch, np, dev, args.seed, smi, regressor, generator, reg_cfg,
                                 proj_cfg, crops(C.BATCH))
    del regressor, generator
    torch.cuda.empty_cache()
    if args.phase in ("16e", "both"):
        out["auto_train"] = C.run_auto_train(torch, np, dev, args.seed, smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, **out}, f, indent=1)
    C.log(json.dumps({phase: {k: v for k, v in res.items() if k not in ("b1_shapes", "shapes")}
                      for phase, res in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
