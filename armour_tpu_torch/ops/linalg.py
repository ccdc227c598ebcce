"""Tiny-matrix linear algebra for the NLP's Gauss-Newton systems.

Port of `armour_tpu/ops/linalg.py:spd_solve_small`.  The JAX package
unrolls the Cholesky factorisation into elementwise ops for the TPU's
vector unit.  Eager PyTorch would launch ~n^3/3 tiny kernels per call for
that, so the port takes the batched library factorisation instead: one
`cholesky_ex` and one `cholesky_solve` over all (world, start) systems.

Soundness note: callers pass SPD matrices (Gauss-Newton Hessian + ridge).
"""

from __future__ import annotations

import torch


def spd_solve_small(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD H of small size.

    H: (..., n, n), g: (..., n) -> x: (..., n); batched over leading dims.
    Cholesky + triangular solves (no pivoting: SPD needs none).
    """
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0]
