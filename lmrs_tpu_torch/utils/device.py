"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A CUDA
request on a machine without a card raises: the port never quietly runs a
device path on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
