"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it raises when PyTorch sees no CUDA device, so a
    run that was meant for the card never carries on on the CPU.  Any other
    value is taken as the caller's explicit choice (``"cpu"`` runs the plain
    PyTorch version of each kernel)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
