"""Default-device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: return ``cuda``, or raise when there is
    none.  Anything else is taken as given (``"cpu"`` runs every kernel
    wrapper's plain PyTorch version)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return torch.device("cuda")
