"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Without a CUDA
device and without an explicit ``device="cpu"`` they raise: nothing carries
on quietly on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA; a CUDA request without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
