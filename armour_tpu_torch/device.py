"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device is returned only when one is
    present; without it this raises rather than running on the CPU.  The
    CPU is used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "armour_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev
