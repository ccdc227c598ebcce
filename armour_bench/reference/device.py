"""Frozen copy of ``armour_tpu_torch/device.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Device resolution shared by every entry point of the port, and the way
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


_CONSTS: dict = {}


def const(x, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """A tensor of host data ``x`` (a numpy array, list or number) on
    ``device``, made once per (value, dtype, device) and kept.  Code that a
    CUDA graph captures may read such constants but may not copy host data
    to the card (the copy synchronises with the host): its first, op-by-op
    run makes them here, and the capture finds them.  Callers must not
    write into the result."""
    a = np.asarray(x)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(a, dtype=dtype, device=device)
    return t


def to_numpy(x) -> np.ndarray:
    """A host numpy array of ``x``: a tensor on any device, or array-like
    (``np.asarray`` alone raises on a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
