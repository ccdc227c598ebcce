"""Device resolution shared by every entry point of the port, and the way
back to the host."""

from __future__ import annotations

import numpy as np
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


def to_numpy(x) -> np.ndarray:
    """A host numpy array of ``x``: a tensor on any device, or array-like
    (``np.asarray`` alone raises on a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
