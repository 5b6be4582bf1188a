"""Where the port runs: the first CUDA card unless the caller asks for
the CPU — never the CPU as a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None, what: str = "this") -> torch.device:
    """``None`` → the first CUDA card, raising when there is none; any
    other value as given (``"cpu"``, ``"cuda:1"``, a ``torch.device``).
    ``what`` names the caller in the error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
