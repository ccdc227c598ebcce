"""The start-pose screen of the traffic generator: whether any link box of
the arm at q meets a live obstacle.  A frozen copy of
``armour_tpu_torch/sim/world.py`` (``obb_aabb_overlap``,
``arm_collision_check``), plain PyTorch."""

from __future__ import annotations

import torch

from armour_bench.reference.device import const
from armour_bench.reference.rnea import forward_kinematics
from armour_bench.reference.spec import RobotSpec
from armour_bench.reference.zonotope import ObstacleSet


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def obb_aabb_overlap(obb_c, obb_R, obb_half, aabb_c, aabb_half):
    """Separating-axis test between an oriented box and an axis-aligned
    box, batched over leading dims (15 candidate axes); True on overlap."""
    d = obb_c - aabb_c
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    axes = [eye[i].expand(d.shape) for i in range(3)]
    axes += [obb_R[..., :, i] for i in range(3)]
    for i in range(3):
        for j in range(3):
            axes.append(_cross(obb_R[..., :, i], axes[j]))
    sep = torch.zeros(d.shape[:-1], dtype=torch.bool, device=d.device)
    for L in axes:
        norm = torch.sqrt(torch.sum(L * L, dim=-1, keepdim=True))
        Ln = torch.where(norm > 1e-9, L / torch.where(norm > 1e-9, norm, 1.0), 0.0)
        dist = torch.sum(d * Ln, dim=-1).abs()
        r_obb = torch.sum(torch.einsum("...i,...ij->...j", Ln, obb_R).abs() * obb_half, dim=-1)
        r_aabb = torch.sum(Ln.abs() * aabb_half, dim=-1)
        degenerate = norm[..., 0] <= 1e-9
        sep = sep | ((dist > r_obb + r_aabb) & ~degenerate)
    return ~sep


def arm_collision_check(spec: RobotSpec, q: torch.Tensor, obstacles: ObstacleSet) -> torch.Tensor:
    """True iff ANY link box at q (..., nf) intersects ANY live obstacle
    (treated as an AABB): (...,) bool."""
    Rw, pw = forward_kinematics(spec, q)
    centers_local = const(spec.link_zono_center, q.dtype, q.device)
    half = const(spec.link_zono_gen, q.dtype, q.device)
    obb_c = torch.einsum("...lij,lj->...li", Rw, centers_local) + pw
    obs_c = obstacles.zonos[..., 0, :]
    obs_half = obstacles.zonos[..., 1:, :].abs().sum(-2)
    hit = obb_aabb_overlap(
        obb_c[..., :, None, :],
        Rw[..., :, None, :, :],
        half[:, None, :],
        obs_c[..., None, :, :],
        obs_half[..., None, :, :],
    )
    hit = hit & obstacles.mask[..., None, :]
    return hit.flatten(-2).any(-1)
