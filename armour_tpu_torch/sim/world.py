"""Worlds, goal checks, and the ground-truth collision screen.

Port of `armour_tpu/sim/world.py`: the planning scenario (`World`), the
configuration- and workspace-goal tests, the OBB-vs-AABB separating-axis
test of arm configurations against box obstacles, and random scenario
generation.  The link volumes checked are exactly the link bounding boxes
the planner certifies, so the screen is conservative with respect to the
exact mesh check (`collision/mesh_oracle.py`): screen-clean implies
mesh-clean.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.device import const, resolve_device
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.planner.armour import wrap_to_pi
from armour_tpu_torch.robots.spec import RobotSpec


class World(NamedTuple):
    """A planning scenario: start/goal configurations + obstacle bank."""

    start: torch.Tensor         # (nf,)
    goal: torch.Tensor          # (nf,)
    obstacles: ObstacleSet
    goal_type: str = "configuration"


def goal_check(spec: RobotSpec, q, goal, goal_radius: float):
    """Configuration-space goal test (`kinova_world_static.m` goal_check):
    every joint within goal_radius, with angdiff on continuous joints."""
    d = q - goal
    cont = const(spec.continuous_joints, device=d.device)
    d = torch.where(cont, wrap_to_pi(d), d)
    return torch.all(d.abs() <= goal_radius, dim=-1)


def goal_check_ee(spec: RobotSpec, q, goal_xyz, goal_radius: float):
    """Workspace goal test ('end_effector_location' goal type,
    `kinova_world_static.m:53-110`): the end effector (the flange offset
    ``spec.trans[n_joints]`` past the last joint) within goal_radius."""
    Rw, pw = forward_kinematics(spec, q)
    flange = const(spec.trans[spec.n_joints], q.dtype, q.device)
    ee = pw[..., -1, :] + torch.einsum("...ij,j->...i", Rw[..., -1, :, :], flange)
    return torch.linalg.vector_norm(ee - goal_xyz, dim=-1) <= goal_radius


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

    q (..., nf); obstacles.zonos (..., O, 4, 3) and mask (..., O) whose
    leading dims broadcast against those of q -> (...,) bool.  Obstacles
    are treated as AABBs (box_obstacle_zonotope is axis-aligned).
    """
    Rw, pw = forward_kinematics(spec, q)          # (..., L, 3, 3), (..., L, 3)
    centers_local = const(spec.link_zono_center, q.dtype, q.device)
    half = const(spec.link_zono_gen, q.dtype, q.device)
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


def random_world(
    spec: RobotSpec,
    n_obstacles: int,
    capacity: int,
    generator: torch.Generator,
    obstacle_size_range=(0.01, 0.5),
    workspace_radius: float = 0.9,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> World:
    """Random scenario generation in the style of `arm_world_static.m`
    (random start/goal + random boxes; the caller should rejection-sample
    against `arm_collision_check` at start/goal like the reference's
    create_random_obstacles path).  Draws come from ``generator`` (the JAX
    package draws from a ``jax.random`` key, so the two worlds differ for
    the same seed); the world lands on ``device``."""
    dev = resolve_device(device)
    nf = spec.n_factors

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return u.to(dev)

    lb = torch.as_tensor(np.where(spec.continuous_joints, -np.pi, spec.pos_limits_lb + 0.05),
                         dtype=dtype, device=dev)
    ub = torch.as_tensor(np.where(spec.continuous_joints, np.pi, spec.pos_limits_ub - 0.05),
                         dtype=dtype, device=dev)
    start = uniform(nf) * (ub - lb) + lb
    goal = uniform(nf) * (ub - lb) + lb
    centers = uniform(n_obstacles, 3) * (2 * workspace_radius) - workspace_radius
    # keep obstacles above the table plane
    centers[:, 2] = centers[:, 2].abs() + 0.1
    lo, hi = obstacle_size_range
    sides = uniform(n_obstacles, 3) * (hi - lo) + lo
    zonos = torch.zeros((capacity, 4, 3), dtype=dtype, device=dev)
    zonos[:n_obstacles, 0] = centers
    for i in range(3):
        zonos[:n_obstacles, 1 + i, i] = sides[:, i] * 0.5
    mask = torch.arange(capacity, device=dev) < n_obstacles
    return World(start=start, goal=goal, obstacles=ObstacleSet(zonos, mask))
