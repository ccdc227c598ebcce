"""Tiny-matrix linear algebra for the NLP's Gauss-Newton systems and the
plant's mass-matrix solves.

Port of `armour_tpu/ops/linalg.py:spd_solve_small`.  The JAX package
unrolls a Cholesky factorisation into scalar elementwise ops for the TPU's
vector unit.  The port eliminates one column at a time over the whole
batch: Gaussian elimination without pivoting on the augmented matrix
[H | g] is the LDL^T form of the same factorisation (pivot j is L_jj^2),
and then one back substitution.  About 45 tensor ops for n = 7, all plain
tensor code with no library solver and no host synchronisation, so the
solve can be captured into a CUDA graph (the batched library routines may
stage pointer arrays in host memory).

Soundness note: callers pass SPD matrices (Gauss-Newton Hessian + ridge,
mass matrix + transmission inertia).  Each pivot is clamped at 1e-30, as
the JAX package clamps L_jj^2, so a numerically semidefinite matrix
degrades gracefully instead of giving NaN.
"""

from __future__ import annotations

import torch


def spd_solve_small(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD H of small size.

    H: (..., n, n), g: (..., n) -> x: (..., n); batched over leading dims.
    LDL^T elimination + back substitution (no pivoting: SPD needs none).
    """
    n = H.shape[-1]
    M = torch.cat([H, g[..., None]], dim=-1)         # (..., n, n + 1), eliminated in place
    piv = []
    for j in range(n):
        piv.append(torch.clamp(M[..., j, j:j + 1], min=1e-30))
        if j < n - 1:
            f = M[..., j + 1:, j] / piv[j]
            M[..., j + 1:, j + 1:] -= f[..., None] * M[..., j:j + 1, j + 1:]
    x = M[..., n]                                    # the eliminated right-hand side
    for j in reversed(range(n)):
        x[..., j:j + 1] /= piv[j]
        if j:
            x[..., :j] -= M[..., :j, j] * x[..., j:j + 1]
    return x.contiguous()
