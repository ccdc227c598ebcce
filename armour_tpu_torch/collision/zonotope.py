"""Buffered-zonotope obstacle constraints.

Port of `armour_tpu/collision/zonotope.py` with the world axis B in front
of every tensor:

- ``buffer_obstacles``: H-rep of the Minkowski sum obstacle ⊕ link
  independent generators, 36 = C(9,2) cross-product hyperplanes, for every
  (world, pair, link, obstacle, time) at once; computed once per plan.
- the bank pass (signed distance of the k-sliced link centers, maximum
  over the hyperplanes, argmax-select Jacobian) goes through
  ``collision/kernels.py``: the CUDA kernels on the card, their plain
  PyTorch versions on the CPU.
- ``collision_constraint_values`` (differentiable hard max) and
  ``smooth_collision_constraints_with_jac`` (log-sum-exp bound) are plain
  tensor code in the JAX package too, and are plain PyTorch here.

Layout: the bank keeps (obstacle, time) as the trailing two dims, so a
thread per (b, l, o, t) reads it coalesced along T.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from armour_tpu_torch.collision import kernels
from armour_tpu_torch.device import const

# generator layout of a buffered obstacle: 3 obstacle + 3 link-shape +
# 3 link-radius generators (CollisionChecking.h:6-7)
N_BUF_GEN = 9
_PAIRS = [(a, b) for a in range(N_BUF_GEN) for b in range(a + 1, N_BUF_GEN)]
COMB_NUM = len(_PAIRS)  # 36
_PAIR_A = [p[0] for p in _PAIRS]
_PAIR_B = [p[1] for p in _PAIRS]

_EXCLUDED = -1e8  # sentinel for degenerate / masked hyperplanes
DEAD_SLOT_VALUE = -1e3  # constraint value of a masked obstacle slot
# smooth mode holds the (B, S, 2P, L, O, T) pieces and a few temporaries of
# their size; starts are processed in chunks whose pieces stay under this
_SMOOTH_PIECES_BYTES = 2 << 30


class ObstacleSet(NamedTuple):
    """Static-capacity obstacle bank.

    ``zonos``: (..., capacity, 4, 3) rows = [center, g1, g2, g3]
    ``mask``: (..., capacity) True for live obstacles
    """

    zonos: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.zonos.shape[-3]

    @staticmethod
    def from_boxes(centers, side_lengths, capacity: int) -> "ObstacleSet":
        """Axis-aligned boxes (center + side lengths) of one world, as numpy
        zonos (capacity, 4, 3) and mask (capacity,): the
        `box_obstacle_zonotope` format (obstacles/box_obstacle_zonotope.m:21-26)."""
        centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        sides = np.atleast_2d(np.asarray(side_lengths, dtype=np.float64))
        n = centers.shape[0] if centers.size else 0
        if n > capacity:
            raise ValueError(f"{n} obstacles > capacity {capacity}")
        z = np.zeros((capacity, 4, 3))
        for i in range(n):
            z[i, 0] = centers[i]
            z[i, 1:] = np.diag(sides[i] * 0.5)
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        return ObstacleSet(z, mask)


class BufferedHyperplanes(NamedTuple):
    """Precomputed H-reps, laid out (world, pair, [component,] link, obstacle, time).

    A: (B, 36, 3, L, O, T)  unit normals (0 for degenerate pairs); bf16 or
                            the offsets' dtype
    dpos: (B, 36, L, O, T)  A.obs_center + sum_g |A.gen_g| (+1e8 at
                            degenerate/dead slots)
    dneg: (B, 36, L, O, T)  -A.obs_center + sum_g |A.gen_g| (same folding)
    obs_mask: (B, O)        live-obstacle mask (dead slots forced feasible)
    """

    A: torch.Tensor
    dpos: torch.Tensor
    dneg: torch.Tensor
    obs_mask: torch.Tensor


def buffer_obstacles(
    link_indep_gens: torch.Tensor,  # (B, T, L, 3, 6) from reduce_link
    obstacles: ObstacleSet,         # zonos (B, O, 4, 3), mask (B, O)
    slack: float = 0.0,
    store_bf16: bool = False,
) -> BufferedHyperplanes:
    """Build the hyperplane bank (CollisionChecking.cu:136-228), batched.

    ``slack`` inflates every obstacle's half-width.  ``store_bf16`` stores
    the normals A in bfloat16 (f32 runs only): A is quantized FIRST and the
    f32 offsets are the support values of the buffered set FOR the
    quantized normals, so every hyperplane still bounds the set exactly
    (see the reference's docstring for the soundness argument).
    """
    B, T, L = link_indep_gens.shape[:3]
    O = obstacles.zonos.shape[1]
    dtype = link_indep_gens.dtype

    zonos = obstacles.zonos.to(dtype)
    obs_c = zonos[:, :, 0, :]                               # (B, O, 3)
    obs_G = zonos[:, :, 1:, :]                              # (B, O, 3 gens, 3)

    # buffered generator stack in compute layout: (B, 9 gens, 3 comps, L, O, T)
    obs_G_b = obs_G.permute(0, 2, 3, 1)[:, :, :, None, :, None].expand(B, 3, 3, L, O, T)
    link_G_b = link_indep_gens.permute(0, 4, 3, 2, 1)[:, :, :, :, None, :].expand(B, 6, 3, L, O, T)
    G = torch.cat([obs_G_b, link_G_b], dim=1)               # (B, 9, 3, L, O, T)

    # cross products of all generator pairs -> normals (B, 36, 3, L, O, T)
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
    norm = torch.sqrt(torch.sum(C * C, dim=2, keepdim=True))  # (B, 36, 1, L, O, T)
    valid = norm[:, :, 0] > 1e-12
    A = torch.where(valid[:, :, None], C / torch.where(norm > 1e-12, norm, 1.0), 0.0)

    if store_bf16 and dtype == torch.float32:
        A = A.to(torch.bfloat16)
    A_f = A.to(dtype)  # offsets in the working dtype FOR the (possibly quantized) A

    d = torch.einsum("bpclot,boc->bplot", A_f, obs_c)
    # sum_g |A . gen_g|, one generator at a time: the (B, 36, 9, L, O, T)
    # product the reference forms in one einsum would not fit at B = 128
    delta = None
    for g in range(N_BUF_GEN):
        term = torch.einsum("bpclot,bclot->bplot", A_f, G[:, g]).abs()
        delta = term if delta is None else delta + term
    delta = delta + slack

    # fold the validity mask into the offsets (see BufferedHyperplanes doc)
    valid = valid & obstacles.mask[:, None, None, :, None]
    big = -_EXCLUDED
    dpos = torch.where(valid, d + delta, big)
    dneg = torch.where(valid, delta - d, big)
    return BufferedHyperplanes(A.contiguous(), dpos.contiguous(), dneg.contiguous(), obstacles.mask)


def kernel_layout(link_centers, dlink_centers=None):
    """(B, S, T, L, 3) centers -> (B, S, 3, L, T); (B, S, n, T, L, 3)
    d centers / dk -> (B, S, n, 3, L, T); both contiguous."""
    c = link_centers.permute(0, 1, 4, 3, 2).contiguous()
    if dlink_centers is None:
        return c
    return c, dlink_centers.permute(0, 1, 2, 5, 4, 3).contiguous()


def mask_dead(hp: BufferedHyperplanes, g, J=None):
    """Dead obstacle slots: g -> -1e3, J -> 0 (`zonotope.py:342-343`)."""
    live = hp.obs_mask[:, None, None, :, None]               # (B, 1, 1, O, 1)
    g = torch.where(live, g, DEAD_SLOT_VALUE)
    if J is None:
        return g
    return g, J * live[:, :, None]


def collision_constraints_with_jac_multi(
    hp: BufferedHyperplanes,
    link_centers: torch.Tensor,   # (B, S, T, L, 3) per-start sliced centers
    dlink_centers: torch.Tensor,  # (B, S, n, T, L, 3)
):
    """Constraint values (feasible iff g <= 0) AND their k-Jacobian for all
    S starts in one pass over the bank (the NLP's hot loop).

    Returns g: (B, S, L, O, T) and J: (B, S, n, L, O, T), the kernel's own
    layout: the NLP flattens (L, O, T) into its constraint axis.
    """
    c, dc = kernel_layout(link_centers, dlink_centers)
    g, J = kernels.fused_collision_value_jac_multi(hp.A, hp.dpos, hp.dneg, c, dc)
    return mask_dead(hp, g, J)


def collision_values_multi(
    hp: BufferedHyperplanes,
    link_centers: torch.Tensor,  # (B, S, T, L, 3)
) -> torch.Tensor:
    """Start-batched constraint values only, one bank pass: (B, S, L, O, T)."""
    g = kernels.fused_collision_values_multi(hp.A, hp.dpos, hp.dneg, kernel_layout(link_centers))
    return mask_dead(hp, g)


def collision_constraints_with_jac(
    hp: BufferedHyperplanes,
    link_centers: torch.Tensor,   # (B, T, L, 3) one sliced k per world
    dlink_centers: torch.Tensor,  # (B, n, T, L, 3)
):
    """Single-start value + Jacobian: g (B, L, O, T), J (B, n, L, O, T)."""
    c, dc = kernel_layout(link_centers[:, None], dlink_centers[:, None])
    g, J = kernels.fused_collision_value_jac(hp.A, hp.dpos, hp.dneg, c[:, 0], dc[:, 0])
    g, J = mask_dead(hp, g[:, None], J[:, None])
    return g[:, 0], J[:, 0]


def collision_constraint_values(
    hp: BufferedHyperplanes,
    link_centers: torch.Tensor,  # (B, S, T, L, 3) k-sliced link centers
) -> torch.Tensor:
    """Constraint values g(k) (B, S, L, O, T): feasible iff g <= 0, as a
    plain differentiable hard max (`CollisionChecking.cu:250-284`).  Masked
    obstacle slots give -1e3; autodiff through the max gives the
    argmax-select gradient.  A NaN propagates, as in ``jnp.max``."""
    vp, vn = kernels.pieces(hp.A, hp.dpos, hp.dneg, kernel_layout(link_centers))
    return mask_dead(hp, -torch.amax(torch.maximum(vp, vn), dim=2))


def smooth_collision_constraints_with_jac(
    hp: BufferedHyperplanes,
    link_centers: torch.Tensor,   # (B, S, T, L, 3)
    dlink_centers: torch.Tensor,  # (B, S, n, T, L, 3)
    tau: float,
):
    """SMOOTH variant of the obstacle constraint (the role of the
    reference's optional Borrelli-dual formulation,
    `uarmtd_planner.m:723-743,810-856`): the hard max over the 2P affine
    separation pieces is replaced by the smooth LOWER bound
    LSE(p/tau)*tau - tau*log(2P) <= max(p), so that

        g_s = tau*log(2P) - tau*LSE(pieces/tau) >= g_hard,

    i.e. the smooth constraint is MORE conservative, everywhere
    differentiable, and within tau*log(2P) of the hard one.  The Jacobian
    is the softmax-weighted combination of the signed normals.

    Returns g (B, S, L, O, T) and J (B, S, n, L, O, T), the kernels' layout.
    Starts are processed in chunks (see ``_SMOOTH_PIECES_BYTES``).
    """
    c, dc = kernel_layout(link_centers, dlink_centers)
    B, P, L, O, T = hp.dpos.shape
    S = c.shape[1]
    per_start = B * 2 * P * L * O * T * hp.dpos.element_size()
    step = max(1, min(S, _SMOOTH_PIECES_BYTES // per_start))
    Af = hp.A.to(hp.dpos.dtype)
    gap = tau * math.log(2 * P)
    gs, Js = [], []
    for s0 in range(0, S, step):
        pieces = torch.cat(kernels.pieces(hp.A, hp.dpos, hp.dneg, c[:, s0:s0 + step]), dim=2)
        m = torch.amax(pieces, dim=2)
        w = torch.exp((pieces - m[:, :, None]) / tau)                       # (B, s, 2P, L, O, T)
        del pieces
        Z = torch.sum(w, dim=2)
        gs.append(gap - (m + tau * torch.log(Z)))
        # dg/dc = sum_p (softmax_neg - softmax_pos)_p A_p: the soft version
        # of the hard path's signed one-hot select
        w.div_(Z[:, :, None])                                               # softmax, in place
        wsel = w[:, :, P:] - w[:, :, :P]                                    # (B, s, P, L, O, T)
        del w
        A_sel = torch.einsum("bsplot,bpclot->bsclot", wsel, Af)
        Js.append(torch.einsum("bsclot,bsnclt->bsnlot", A_sel, dc[:, s0:s0 + step]))
    return mask_dead(hp, torch.cat(gs, dim=1), torch.cat(Js, dim=1))
