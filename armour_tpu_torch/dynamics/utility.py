"""Kinematics/dynamics utility kit: the modern-robotics helpers
(`simulator/dynamics/utility/`: FKinSpace, JacobianSpace, MassMatrix,
InverseDynamicsTrajectory, ForwardDynamicsTrajectory, ...).

Port of `armour_tpu/dynamics/utility.py`.  Everything composes the RNEA/FK
primitives of ``dynamics/rnea.py`` and takes arbitrary leading batch dims.
"""

from __future__ import annotations

import torch
from torch.func import jvp, vmap

from armour_tpu_torch.device import const
from armour_tpu_torch.dynamics.rnea import (
    bias_forces,
    forward_kinematics,
    mass_matrix,
    rnea,
)
from armour_tpu_torch.robots.spec import RobotSpec


def ee_pose(spec: RobotSpec, q):
    """End-effector (R, p) in the world frame (FKinSpace equivalent)."""
    Rw, pw = forward_kinematics(spec, q)
    R_ee = Rw[..., -1, :, :]
    t_ee = const(spec.trans[spec.n_joints], q.dtype, q.device)
    p_ee = pw[..., -1, :] + torch.einsum("...ij,j->...i", R_ee, t_ee)
    return R_ee, p_ee


def ee_position_jacobian(spec: RobotSpec, q):
    """Jacobian of the end-effector position, (..., 3, n_factors): one
    forward-mode tangent per joint, pushed through every row at once (each
    row's position depends on its own q only), as ``jax.jacfwd`` of one
    row pushes n_factors tangents.  No row meets another, so a row's result
    does not depend on the rest of the batch."""
    nf = spec.n_factors
    eye = torch.eye(nf, dtype=q.dtype, device=q.device)
    tangents = eye.reshape((nf,) + (1,) * (q.ndim - 1) + (nf,)).expand((nf,) + q.shape)
    Jv = vmap(lambda v: jvp(lambda qq: ee_pose(spec, qq)[1], (q,), (v,))[1])(tangents)
    return Jv.movedim(0, -1)                                        # (nf, ..., 3) -> (..., 3, nf)


def ee_jacobian(spec: RobotSpec, q):
    """Geometric Jacobian of the end-effector position+orientation:
    (..., 6, n_factors), rows = [v; w] (JacobianSpace equivalent), via
    forward-mode autodiff of FK + the rotation-axis stack."""
    nf = spec.n_factors
    Jv = ee_position_jacobian(spec, q)
    # angular part: world axes of each joint
    Rw, _ = forward_kinematics(spec, q)
    cols = []
    for i in range(nf):
        a = abs(int(spec.axes[i])) - 1
        sgn = 1.0 if spec.axes[i] > 0 else -1.0
        cols.append(sgn * Rw[..., i, :, a])
    Jw = torch.stack(cols, dim=-1)
    return torch.cat([Jv, Jw], dim=-2)


def inverse_dynamics_trajectory(spec: RobotSpec, qs, qds, qdds, use_gravity=True):
    """Torques along a trajectory (InverseDynamicsTrajectory): (..., N, nf)."""
    return rnea(spec, qs, qds, qds, qdds, use_gravity=use_gravity)


def forward_dynamics(spec: RobotSpec, q, qd, u):
    """qdd = M^-1 (u - C qd - g) with transmission inertia included."""
    M = mass_matrix(spec, q, include_armature=True)
    b = bias_forces(spec, q, qd)
    return torch.linalg.solve(M, u - b)


def forward_dynamics_trajectory(spec: RobotSpec, q0, qd0, us, dt: float):
    """Semi-implicit Euler rollout under a torque sequence ``us`` (..., N, nf)
    (ForwardDynamicsTrajectory): returns (qs, qds) of shape (..., N+1, nf)."""
    q, qd = q0, qd0
    qs, qds = [q0], [qd0]
    for j in range(us.shape[-2]):
        qdd = forward_dynamics(spec, q, qd, us[..., j, :])
        qd = qd + dt * qdd
        q = q + dt * qd
        qs.append(q)
        qds.append(qd)
    return torch.stack(qs, dim=-2), torch.stack(qds, dim=-2)


def gravity_torque(spec: RobotSpec, q):
    """g(q) alone (GravityForces equivalent)."""
    z = torch.zeros_like(q)
    return rnea(spec, q, z, z, z, use_gravity=True, use_armature=False)


def coriolis_torque(spec: RobotSpec, q, qd):
    """C(q, qd) qd alone (VelQuadraticForces equivalent)."""
    return bias_forces(spec, q, qd) - gravity_torque(spec, q)
