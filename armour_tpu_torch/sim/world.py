"""Ground-truth collision screen of arm configurations against box obstacles.

Port of `armour_tpu/sim/world.py:56-111` (`obb_aabb_overlap`,
`arm_collision_check`), the part the problem generator's start-volume
screen needs.  Worlds, goals and scenarios wait for the sim slice.
"""

from __future__ import annotations

import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.robots.spec import RobotSpec


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def obb_aabb_overlap(obb_c, obb_R, obb_half, aabb_c, aabb_half):
    """Separating-axis test between an oriented box (center, rotation,
    half-extents) and an axis-aligned box, batched over leading dims.

    15 candidate axes: 3 world axes, 3 OBB axes, 9 cross products.
    Returns True when the boxes overlap.
    """
    d = obb_c - aabb_c  # (..., 3)
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
    """True iff ANY link box intersects ANY live obstacle.

    q (..., nf); obstacles.zonos (..., O, 4, 3) and mask (..., O) with the
    same leading dims as q -> (...,) bool.  Obstacles are treated as AABBs
    (box_obstacle_zonotope is axis-aligned).
    """
    Rw, pw = forward_kinematics(spec, q)          # (..., L, 3, 3), (..., L, 3)
    centers_local = torch.as_tensor(spec.link_zono_center, dtype=q.dtype, device=q.device)
    half = torch.as_tensor(spec.link_zono_gen, dtype=q.dtype, device=q.device)
    obb_c = torch.einsum("...lij,lj->...li", Rw, centers_local) + pw  # (..., L, 3)

    obs_c = obstacles.zonos[..., 0, :]                               # (..., O, 3)
    obs_half = obstacles.zonos[..., 1:, :].abs().sum(-2)              # (..., O, 3)

    hit = obb_aabb_overlap(
        obb_c[..., :, None, :],
        Rw[..., :, None, :, :],
        half[:, None, :],
        obs_c[..., None, :, :],
        obs_half[..., None, :, :],
    )                                                                 # (..., L, O)
    hit = hit & obstacles.mask[..., None, :]
    return hit.flatten(-2).any(-1)
