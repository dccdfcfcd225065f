"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for but no CUDA device is available; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    return dev
