"""The obstacle side of the plain reference: the obstacle set, the
hyperplane bank of each (world, link, obstacle, time) and the exact hard
maximum over it.

``buffer_obstacles`` is a frozen copy of
``armour_tpu_torch/collision/zonotope.py::buffer_obstacles`` and
``pieces`` of ``armour_tpu_torch/collision/kernels.py::pieces`` (plain
PyTorch both).  The reference calls them in float64 with exact normals
(``store_bf16=False``) and no slack: the geometry as stated, which the
program's float32 bank with bfloat16 normals and its slack must bound.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from armour_bench.reference.device import const

# generator layout of a buffered obstacle: 3 obstacle + 3 link-shape +
# 3 link-radius generators (CollisionChecking.h:6-7)
N_BUF_GEN = 9
_PAIRS = [(a, b) for a in range(N_BUF_GEN) for b in range(a + 1, N_BUF_GEN)]
_PAIR_A = [p[0] for p in _PAIRS]
_PAIR_B = [p[1] for p in _PAIRS]

_EXCLUDED = -1e8  # sentinel for degenerate / masked hyperplanes
DEAD_SLOT_VALUE = -1e3  # constraint value of a masked obstacle slot


class ObstacleSet(NamedTuple):
    """``zonos`` (..., capacity, 4, 3) rows [center, g1, g2, g3]; ``mask``
    (..., capacity) True for live obstacles."""

    zonos: torch.Tensor
    mask: torch.Tensor


class BufferedHyperplanes(NamedTuple):
    """A (B, 36, 3, L, O, T) unit normals; dpos, dneg (B, 36, L, O, T)
    offsets (+1e8 at degenerate or dead slots); obs_mask (B, O)."""

    A: torch.Tensor
    dpos: torch.Tensor
    dneg: torch.Tensor
    obs_mask: torch.Tensor


def buffer_obstacles(link_indep_gens, obstacles: ObstacleSet, slack: float = 0.0,
                     store_bf16: bool = False) -> BufferedHyperplanes:
    """The hyperplane bank (CollisionChecking.cu:136-228), batched:
    link_indep_gens (B, T, L, 3, 6), obstacles zonos (B, O, 4, 3)."""
    B, T, L = link_indep_gens.shape[:3]
    O = obstacles.zonos.shape[1]
    dtype = link_indep_gens.dtype

    zonos = obstacles.zonos.to(dtype)
    obs_c = zonos[:, :, 0, :]
    obs_G = zonos[:, :, 1:, :]
    obs_G_b = obs_G.permute(0, 2, 3, 1)[:, :, :, None, :, None].expand(B, 3, 3, L, O, T)
    link_G_b = link_indep_gens.permute(0, 4, 3, 2, 1)[:, :, :, :, None, :].expand(B, 6, 3, L, O, T)
    G = torch.cat([obs_G_b, link_G_b], dim=1)               # (B, 9, 3, L, O, T)

    ga = G[:, const(_PAIR_A, device=G.device)]
    gb = G[:, const(_PAIR_B, device=G.device)]
    C = torch.stack(
        [
            ga[:, :, 1] * gb[:, :, 2] - ga[:, :, 2] * gb[:, :, 1],
            ga[:, :, 2] * gb[:, :, 0] - ga[:, :, 0] * gb[:, :, 2],
            ga[:, :, 0] * gb[:, :, 1] - ga[:, :, 1] * gb[:, :, 0],
        ],
        dim=2,
    )
    norm = torch.sqrt(torch.sum(C * C, dim=2, keepdim=True))
    valid = norm[:, :, 0] > 1e-12
    A = torch.where(valid[:, :, None], C / torch.where(norm > 1e-12, norm, 1.0), 0.0)

    if store_bf16 and dtype == torch.float32:
        A = A.to(torch.bfloat16)
    A_f = A.to(dtype)

    d = torch.einsum("bpclot,boc->bplot", A_f, obs_c)
    delta = None
    for g in range(N_BUF_GEN):
        term = torch.einsum("bpclot,bclot->bplot", A_f, G[:, g]).abs()
        delta = term if delta is None else delta + term
    delta = delta + slack

    valid = valid & obstacles.mask[:, None, None, :, None]
    big = -_EXCLUDED
    dpos = torch.where(valid, d + delta, big)
    dneg = torch.where(valid, delta - d, big)
    return BufferedHyperplanes(A.contiguous(), dpos.contiguous(), dneg.contiguous(), obstacles.mask)


def pieces(A, dpos, dneg, c):
    """The 2P affine separation pieces vp = A.c - dpos, vn = -A.c - dneg,
    each (B, S, P, L, O, T), for A (B,P,3,L,O,T) and c (B,S,3,L,T)."""
    Af = A.to(dpos.dtype)[:, None]
    cc = c[:, :, None, :, :, None, :]
    Ac = Af[:, :, :, 0] * cc[:, :, :, 0] + Af[:, :, :, 1] * cc[:, :, :, 1] + Af[:, :, :, 2] * cc[:, :, :, 2]
    return Ac - dpos[:, None], -Ac - dneg[:, None]


def collision_values(hp: BufferedHyperplanes, link_centers) -> torch.Tensor:
    """g (B, S, L, O, T), feasible iff g <= 0, for link centers
    (B, S, T, L, 3): the hard maximum over the pieces (a NaN propagates),
    dead slots at -1e3."""
    c = link_centers.permute(0, 1, 4, 3, 2)
    vp, vn = pieces(hp.A, hp.dpos, hp.dneg, c)
    g = -torch.amax(torch.maximum(vp, vn), dim=2)
    live = hp.obs_mask[:, None, None, :, None]
    return torch.where(live, g, DEAD_SLOT_VALUE)
