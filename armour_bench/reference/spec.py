"""Frozen copy of ``armour_tpu_torch/robots/spec.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Typed robot specification — the single source of truth for both the host
orchestration and the jitted kernels.

Replaces the reference's split model layer (L1): hard-coded C++ headers
(`kinova_planner_realtime/KinovaWithoutGripperInfo.h`), MATLAB
`load_robot_params.m`, and the controller's `kinova.txt` spatial-model file,
which had to be kept manually consistent (SURVEY.md §5 "Config / flag
system").
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    """Serial-manipulator specification.

    Conventions follow the reference planner core
    (`KinovaWithoutGripperInfo.h:9-113`):

    - ``axes[i]``: rotation axis of joint i in its own frame; 1/2/3 = x/y/z,
      negative = reversed, 0 = fixed joint.  Fixed joints must come last.
    - ``trans[i]``: origin of frame i in frame i-1 (URDF ``xyz``), with one
      extra row for the end-effector frame.
    - ``rots[i]``: fixed roll-pitch-yaw of frame i in frame i-1 (URDF ``rpy``).
    - ``link_zono_center/gen``: axis-aligned link bounding boxes in the link
      frame (zonotope center + half side-lengths).
    """

    name: str
    n_joints: int          # bodies in the chain (NUM_JOINTS)
    n_factors: int         # actuated joints == trajectory parameters (NUM_FACTORS)

    axes: np.ndarray       # (n_joints,) int
    trans: np.ndarray      # (n_joints + 1, 3)
    rots: np.ndarray       # (n_joints, 3) rpy

    mass: np.ndarray       # (n_joints,)
    com: np.ndarray        # (n_joints, 3)
    inertia: np.ndarray    # (n_joints, 3, 3) about the COM, link frame

    mass_uncertainty: float
    com_uncertainty: float
    inertia_uncertainty: float

    friction: np.ndarray   # (n_joints,)
    damping: np.ndarray    # (n_joints,)
    armature: np.ndarray   # (n_joints,) motor transmission inertia

    pos_limits_lb: np.ndarray  # (n_factors,) 1000.0 => continuous joint
    pos_limits_ub: np.ndarray
    speed_limits: np.ndarray   # (n_factors,)
    torque_limits: np.ndarray  # (n_factors,)

    gravity: float

    link_zono_center: np.ndarray  # (n_joints, 3)
    link_zono_gen: np.ndarray     # (n_joints, 3) half side lengths

    # robust-controller / ultimate-bound parameters
    # (KinovaWithoutGripperInfo.h:102-112, uarmtd_robust_CBF_LLC.m:31-45)
    alpha: float = 10.0
    v_max: float = 1e-2
    m_max_eig: float = 0.0
    m_min_eig: float = 1.0
    kr: float = 5.0

    # optional per-joint collision STL paths (link frames), for the exact
    # mesh-level ground-truth oracle (collision/mesh_oracle.py); None entries
    # fall back to the link bounding box
    mesh_paths: tuple | None = None

    @property
    def ultimate_bound(self) -> float:
        """eps = sqrt(2 V_max / M_min)."""
        return math.sqrt(2.0 * self.v_max / self.m_min_eig)

    @property
    def qe(self) -> float:
        """position tracking-error bound eps / Kr."""
        return self.ultimate_bound / self.kr

    @property
    def qde(self) -> float:
        """velocity tracking-error bound 2 eps."""
        return 2.0 * self.ultimate_bound

    @property
    def qdae(self) -> float:
        """auxiliary-velocity error bound eps."""
        return self.ultimate_bound

    @property
    def qddae(self) -> float:
        """auxiliary-acceleration error bound 2 Kr eps."""
        return 2.0 * self.kr * self.ultimate_bound

    @property
    def continuous_joints(self) -> np.ndarray:
        """Boolean mask of unlimited (continuous) actuated joints."""
        return self.pos_limits_ub >= 999.0

    def fixed_rotations(self) -> np.ndarray:
        """(n_joints + 1, 3, 3) fixed frame rotations from rpy.

        Composition R = Rz(yaw) @ Ry(pitch) @ Rx(roll), matching the
        reference's rotation-matrix constructor (`PZsparse.cu:160-176`).
        The extra last entry is the identity end-effector frame.
        """
        out = np.zeros((self.n_joints + 1, 3, 3))
        for i in range(self.n_joints):
            r, p, y = self.rots[i]
            cr, sr = math.cos(r), math.sin(r)
            cp, sp = math.cos(p), math.sin(p)
            cy, sy = math.cos(y), math.sin(y)
            out[i] = np.array(
                [
                    [cp * cy, -cp * sy, sp],
                    [cr * sy + cy * sp * sr, cr * cy - sp * sr * sy, -cp * sr],
                    [sr * sy - cr * cy * sp, cy * sr + cr * sp * sy, cp * cr],
                ]
            )
        out[self.n_joints] = np.eye(3)
        return out

    def __post_init__(self):
        assert self.axes.shape == (self.n_joints,)
        assert self.trans.shape == (self.n_joints + 1, 3)
        assert self.rots.shape == (self.n_joints, 3)
        assert self.mass.shape == (self.n_joints,)
        assert self.com.shape == (self.n_joints, 3)
        assert self.inertia.shape == (self.n_joints, 3, 3)
        # fixed joints must trail the actuated ones (Trajectory.cu:247-251)
        assert all(a != 0 for a in self.axes[: self.n_factors])
        assert all(a == 0 for a in self.axes[self.n_factors :])
