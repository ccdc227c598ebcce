"""Point forward kinematics.

Port of `armour_tpu/dynamics/rnea.py:25-72` (`joint_rotations`,
`forward_kinematics`), the part the problem generator's start-volume screen
needs.  The point and interval RNEA wait for a later slice.
"""

from __future__ import annotations

import torch

from armour_tpu_torch.robots.spec import RobotSpec


def _axis_rotation(axis: int, q: torch.Tensor) -> torch.Tensor:
    """R(axis, q) with axis in {±1, ±2, ±3} (rx/ry/rz)."""
    sgn = 1.0 if axis > 0 else -1.0
    a = abs(axis) - 1
    c = torch.cos(q)
    s = sgn * torch.sin(q)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    if a == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif a == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def joint_rotations(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """Per-joint rotation R_i (frame i in frame i-1): (..., n_joints+1, 3, 3)."""
    fixed = spec.fixed_rotations()
    Rs = []
    for i in range(spec.n_joints):
        F = torch.as_tensor(fixed[i], dtype=q.dtype, device=q.device)
        if spec.axes[i] != 0:
            Rs.append(F @ _axis_rotation(int(spec.axes[i]), q[..., i]))
        else:
            Rs.append(F.expand(q.shape[:-1] + (3, 3)))
    Rs.append(torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3)))
    return torch.stack(Rs, dim=-3)


def forward_kinematics(spec: RobotSpec, q: torch.Tensor):
    """World-frame (R_w, p_w) per joint frame: ((..., n, 3, 3), (..., n, 3)).

    Matches the accumulation in `Dynamics.cu:69-81` (p is the joint frame
    origin; link volumes are R_w @ link_zono + p).
    """
    R = joint_rotations(spec, q)
    trans = torch.as_tensor(spec.trans, dtype=q.dtype, device=q.device)
    Rw = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3))
    pw = q.new_zeros(q.shape[:-1] + (3,))
    Rws, pws = [], []
    for i in range(spec.n_joints):
        pw = pw + torch.einsum("...ab,b->...a", Rw, trans[i])
        Rw = torch.einsum("...ab,...bc->...ac", Rw, R[..., i, :, :])
        Rws.append(Rw)
        pws.append(pw)
    return torch.stack(Rws, dim=-3), torch.stack(pws, dim=-2)
