"""ARMOUR robust CBF passivity controller (+ ALTHOFF comparison variant,
nominal passivity and PID baselines).

Port of `armour_tpu/control/robust.py`, the rebuild of
`uarmtd_robust_CBF_LLC.m:58-189` and
`kinova_robust_controllers_mex/robust_controller.cpp:62-175`.

Control law (ARMOUR):
    r       = (qd_des - qd) + Kr (q_des - q)
    tau     = RNEA(q, qd, qd_ref, qdd_ref)          (nominal params)
    Phi     = interval RNEA disturbance bound       (±3% inertia)
    V       = sup 0.5 r^T M_int r                   (interval mass, incl.
                                                     transmission inertia)
    h       = -V + V_max
    lambda  = max(0, -alpha h / ||r|| + ||Phi||)
    u       = tau + lambda * r / ||r||

Everything broadcasts over leading batch dims.  Every law takes the
optional ``consts`` (the nominal link constants as device tensors,
``dynamics.rnea.link_constants``) so a rollout builds them once; the joint
rotations of ``q`` are computed once per call and shared by its RNEA passes.
"""

from __future__ import annotations

import math

import torch

from armour_tpu_torch.dynamics.rnea import (
    LinkConstants,
    joint_rotations,
    link_constants,
    rnea,
    rnea_interval,
    rnea_with_bound,
)
from armour_tpu_torch.robots.spec import RobotSpec


def _wrap(x):
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def _position_error(spec: RobotSpec, a, b, wrap_continuous: bool, consts: LinkConstants | None):
    """a - b, wrapped to [-pi, pi) on the continuous joints."""
    err = a - b
    if wrap_continuous:
        cont = (torch.as_tensor(spec.continuous_joints, device=err.device) if consts is None
                else consts.continuous)
        err = torch.where(cont, _wrap(err), err)
    return err


def _passivity_reference(spec, q, qd, q_des, qd_des, qdd_des, wrap_continuous, consts):
    """(qd_ref, qdd_ref, r) of the modified reference shared by the
    passivity laws."""
    err = _position_error(spec, q_des, q, wrap_continuous, consts)
    d_err = qd_des - qd
    return qd_des + spec.kr * err, qdd_des + spec.kr * d_err, d_err + spec.kr * err


def robust_control(
    spec: RobotSpec,
    q,
    qd,
    q_des,
    qd_des,
    qdd_des,
    mass_scale: tuple[float, float] | None = None,
    r_norm_threshold: float = 1e-9,
    wrap_continuous: bool = True,
    consts: LinkConstants | None = None,
):
    """Returns (u, tau_nominal, v_robust), each (..., nf).

    ``mass_scale`` overrides the inertial uncertainty range for the
    disturbance bound (`kinova_compare_robust_controller.m:17-30`).
    """
    if consts is None:
        consts = link_constants(spec, q)
    qd_ref, qdd_ref, r = _passivity_reference(spec, q, qd, q_des, qd_des, qdd_des, wrap_continuous, consts)
    R = joint_rotations(spec, q, consts)

    # nominal feedforward+feedback torque (incl. transmission inertia, as in
    # the MEX model's transI term) and the disturbance bound Phi (interval
    # RNEA minus nominal), from one shared forward pass
    tau, du = rnea_with_bound(spec, q, qd, qd_ref, qdd_ref, use_gravity=True,
                              mass_scale=mass_scale, use_armature=True, consts=consts, R=R)
    phi = 0.5 * ((tau + du) - (tau - du))  # (..., nf) symmetric bound
    rho = torch.linalg.vector_norm(phi, dim=-1)

    # Lyapunov bound V = sup 0.5 r^T M_int r via the RNEA trick
    # (robust_controller.cpp:137-146): M r = RNEA(q, 0, 0, r, no gravity)
    z = torch.zeros_like(q)
    Mr = rnea_interval(spec, q, z, z, r, use_gravity=False, mass_scale=mass_scale,
                       use_armature=True, consts=consts, R=R)
    V_sup = 0.5 * torch.sum(torch.maximum(r * Mr.lo, r * Mr.hi), dim=-1)

    h = -V_sup + spec.v_max
    r_norm = torch.linalg.vector_norm(r, dim=-1)
    safe_norm = torch.where(r_norm > r_norm_threshold, r_norm, 1.0)
    lam = torch.clamp(-spec.alpha * h / safe_norm + rho, min=0.0)
    v = torch.where((r_norm > r_norm_threshold)[..., None],
                    lam[..., None] * r / safe_norm[..., None], 0.0)
    return tau + v, tau, v


def althoff_control(
    spec: RobotSpec,
    q,
    qd,
    q_des,
    qd_des,
    qdd_des,
    kp=(28.1037, 2.0),
    ki=(2.0, 0.2),
    e_acc=0.0,
    mass_scale: tuple[float, float] | None = None,
    consts: LinkConstants | None = None,
):
    """ALTHOFF PI-gain robust variant (`robust_controller.cpp:118-130`,
    `kinova_controller_ALTHOFF.cpp`): v = (kappa ||Phi|| + phi_t) r."""
    if consts is None:
        consts = link_constants(spec, q)
    qd_ref, qdd_ref, r = _passivity_reference(spec, q, qd, q_des, qd_des, qdd_des, True, consts)
    tau, du = rnea_with_bound(spec, q, qd, qd_ref, qdd_ref, use_gravity=True,
                              mass_scale=mass_scale, use_armature=True, consts=consts)
    phi = 0.5 * ((tau + du) - (tau - du))
    phi_t = kp[0] + ki[0] * e_acc
    kappa_t = kp[1] + ki[1] * e_acc
    v = (kappa_t * torch.linalg.vector_norm(phi, dim=-1) + phi_t)[..., None] * r
    return tau + v, tau, v


def nominal_passivity_control(
    spec: RobotSpec,
    q,
    qd,
    q_des,
    qd_des,
    qdd_des,
    wrap_continuous: bool = True,
    consts: LinkConstants | None = None,
):
    """Nominal passivity LLC (`uarmtd_nominal_passivity_LLC.m:26-66`): the
    same modified reference (qd_ref, qdd_ref) as the robust law, but the
    input is JUST the nominal RNEA torque: no robust term, no ultimate
    bound guarantee.  Returns (u, tau, v=0)."""
    qd_ref, qdd_ref, _ = _passivity_reference(spec, q, qd, q_des, qd_des, qdd_des, wrap_continuous,
                                              consts)
    tau = rnea(spec, q, qd, qd_ref, qdd_ref, use_gravity=True, use_armature=True, consts=consts)
    return tau, tau, torch.zeros_like(tau)


def pid_control(
    spec: RobotSpec,
    q,
    qd,
    q_des,
    qd_des,
    qdd_des,
    i_err,
    k_ff: float = 1.0,
    k_p: float = 100.0,
    k_d: float = 10.0,
    k_i: float = 0.01,
    wrap_continuous: bool = True,
    consts: LinkConstants | None = None,
):
    """Classical PID + feedforward baseline (`robot_arm_PID_LLC.m:36-90`,
    default gains K_ff=1, K_p=100, K_d=10, K_i=0.01): u = K_ff u_ref
    - K_p e_pos - K_d e_vel - K_i int(e_pos), with the nominal RNEA torque
    along the reference as feedforward.  ``i_err``: integrated position
    error, threaded by the rollout.  Returns (u, u_ref, v = feedback part)."""
    e = _position_error(spec, q, q_des, wrap_continuous, consts)
    de = qd - qd_des
    u_ref = rnea(spec, q_des, qd_des, qd_des, qdd_des, use_gravity=True, use_armature=True,
                 consts=consts)
    v = -k_p * e - k_d * de - k_i * i_err
    return k_ff * u_ref + v, u_ref, v
