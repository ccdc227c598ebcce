"""Programmatic planar n-link arms: the 2-D robots of the legacy rotatotope
planners (`robot_arm_rotatotope_RTD_planner_2D_2link.m` / `_2D_6link.m`).

Own copy of `armour_tpu/robots/planar.py`.  All joints rotate about z and
links extend along +x, so the chain lives in the z = base_height plane and
the same 3-D planner stack (PZ-FK, obstacle bank, self-intersection pairs)
runs unchanged.
"""

from __future__ import annotations

import numpy as np

from armour_tpu_torch.robots.spec import RobotSpec


def planar_arm_spec(
    n_links: int = 2,
    link_length: float = 0.5,
    link_mass: float = 1.0,
    base_height: float = 0.1,
) -> RobotSpec:
    """An n-link planar manipulator (z-axis revolute chain).

    The reference 2-D arms' scale (unit-ish links, rod inertia); torque
    limits are generous because the 2-D planners constrain only collision
    and state limits (`robot_arm_rotatotope_RTD_planner_2D_2link.m`)."""
    n = n_links
    L, m = link_length, link_mass
    trans = np.zeros((n + 1, 3))
    trans[0] = [0.0, 0.0, base_height]
    trans[1:, 0] = L
    rod = m * L * L / 12.0
    inertia = np.tile(np.diag([1e-4, rod, rod]), (n, 1, 1))
    com = np.tile([L / 2.0, 0.0, 0.0], (n, 1))
    return RobotSpec(
        name=f"planar{n}",
        n_joints=n,
        n_factors=n,
        axes=np.full(n, 3, int),
        trans=trans,
        rots=np.zeros((n, 3)),
        mass=np.full(n, m),
        com=com,
        inertia=inertia,
        mass_uncertainty=0.03,
        com_uncertainty=0.0,
        inertia_uncertainty=0.03,
        friction=np.zeros(n),
        damping=np.zeros(n),
        armature=np.zeros(n),
        pos_limits_lb=np.full(n, -np.pi),
        pos_limits_ub=np.full(n, np.pi),
        speed_limits=np.full(n, 2.0),
        torque_limits=np.full(n, 100.0),
        gravity=0.0,  # planar arms move in the horizontal plane
        link_zono_center=np.tile([L / 2.0, 0.0, 0.0], (n, 1)),
        link_zono_gen=np.tile([L / 2.0, 0.04, 0.04], (n, 1)),
        m_max_eig=float(n * (m * L * L)),
    )
