"""Frozen copy of ``armour_tpu_torch/dynamics/pz_rnea.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Polynomial-zonotope forward kinematics + RNEA over the joint chain.

Port of `armour_tpu/dynamics/pz_rnea.py` (see its module docstring for the
disturbance-bound redesign): the joint chain is unrolled in Python and
every PZ op is batched over (B worlds, T time subintervals).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from armour_bench.reference.config import PlannerConfig
from armour_bench.reference.device import const
from armour_bench.reference.bezier import BezierJRS
from armour_bench.reference.pz import (
    PZ,
    SHAPE_X,
    SHAPE_Y,
    SHAPE_Z,
    pz_component,
    pz_cross,
    pz_matmat,
    pz_matvec,
    pz_mul,
    pz_set_component,
)
from armour_bench.reference.spec import RobotSpec


class ArmReachableSets(NamedTuple):
    """Per-timestep reachable sets consumed by the NLP.

    - ``link_pz[i]``: k-only 3-vector PZ of link i's volume center, batch (B, T)
    - ``link_indep_gens``: (B, T, n_joints, 3, 6) shape generators + radius
      diag (layout of `PZsparse.cu:370-402` reduce_link_PZ)
    - ``u_nom[i]``: k-only scalar torque PZ, batch (B, T)
    - ``torque_radius``: (B, T, n_factors) total control-input radius
      (`armour_main.cu:176-211`)
    - ``grasp_cons``: empty, or 3 k-only scalar constraint PZs (separation,
      slipping, tipping), feasible iff center(k) + radius <= 0
    """

    link_pz: list
    link_indep_gens: torch.Tensor
    u_nom: list
    torque_radius: torch.Tensor
    grasp_cons: tuple = ()


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """A robot constant in the dtype and on the device of ``like``."""
    return const(x, like.dtype, like.device)


def _link_zono_pz(spec: RobotSpec, i: int, like: torch.Tensor) -> PZ:
    """Link bounding-box PZ in the link frame with tagged shape generators
    (`Dynamics.cu:51-66`)."""
    g = spec.link_zono_gen[i]
    keys = [((SHAPE_X, 1),), ((SHAPE_Y, 1),), ((SHAPE_Z, 1),)]
    coeffs = [
        _vec([g[0], 0.0, 0.0], like),
        _vec([0.0, g[1], 0.0], like),
        _vec([0.0, 0.0, g[2]], like),
    ]
    return PZ.from_gens(_vec(spec.link_zono_center[i], like), keys, coeffs, nval=1)


def pz_forward_kinematics(spec: RobotSpec, jrs: BezierJRS):
    """Link-volume PZs via the FK accumulation of `Dynamics.cu:69-81`.

    Returns (link_pz list, link_indep_gens (B, T, n_joints, 3, 6)).
    """
    like = jrs.R[0].c
    bt = like.shape[:2]
    FK_R = PZ.const(torch.eye(3, dtype=like.dtype, device=like.device).expand(bt + (3, 3)), nval=2)
    FK_T = PZ.const(like.new_zeros(bt + (3,)), nval=1)

    link_pz, gens = [], []
    for i in range(spec.n_joints):
        P = PZ.const(_vec(spec.trans[i], like), nval=1)
        FK_T = FK_T + pz_matvec(FK_R, P)
        FK_R = pz_matmat(FK_R, jrs.R[i])
        link_i = pz_matvec(FK_R, _link_zono_pz(spec, i, like)) + FK_T
        pz_k, g = link_i.reduce_link()
        link_pz.append(pz_k)
        gens.append(g)
    return link_pz, torch.stack(gens, dim=2)


def _pz_rnea_forward(spec: RobotSpec, jrs: BezierJRS):
    """Velocity/acceleration PZ recursion (`Dynamics.cu:101-155`)."""
    like = jrs.R[0].c
    bt = like.shape[:2]

    def zero():
        return PZ.const(like.new_zeros(bt + (3,)), nval=1)

    w, w_aux, wdot = zero(), zero(), zero()
    acc0 = like.new_zeros(bt + (3,)) + _vec([0.0, 0.0, spec.gravity], like)
    acc = PZ.const(acc0, nval=1)

    ws, w_auxs, wdots, accs = [], [], [], []
    for i in range(spec.n_joints):
        Rt = jrs.R_t[i]
        P = PZ.const(_vec(spec.trans[i], like), nval=1)
        acc = pz_matvec(Rt, acc + pz_cross(wdot, P) + pz_cross(w, pz_cross(w_aux, P)))
        w = pz_matvec(Rt, w)
        w_aux = pz_matvec(Rt, w_aux)
        wdot = pz_matvec(Rt, wdot)
        if spec.axes[i] != 0:
            a = abs(int(spec.axes[i])) - 1
            sgn = 1.0 if spec.axes[i] > 0 else -1.0
            qd_i = jrs.qd_des[i].scale(sgn)
            qda_i = jrs.qda_des[i].scale(sgn)
            qdda_i = jrs.qdda_des[i].scale(sgn)
            w = pz_set_component(w, a, qd_i)
            temp = pz_set_component(zero(), a, qd_i)
            wdot = wdot + pz_cross(w_aux, temp)
            wdot = pz_set_component(wdot, a, qdda_i)
            w_aux = pz_set_component(w_aux, a, qda_i)
        ws.append(w)
        w_auxs.append(w_aux)
        wdots.append(wdot)
        accs.append(acc)
    return ws, w_auxs, wdots, accs


def _pz_rnea_backward(spec, jrs, ws, w_auxs, wdots, accs, mass_pz, inertia_pz,
                      include_actuation: bool):
    """Force PZ recursion with given inertial-parameter PZs
    (`Dynamics.cu:148-180`)."""
    like = jrs.R[0].c
    bt = like.shape[:2]
    n = spec.n_joints
    Fs, Ns = [], []
    for i in range(n):
        com = PZ.const(_vec(spec.com[i], like), nval=1)
        acc_com = accs[i] + pz_cross(wdots[i], com) + pz_cross(ws[i], pz_cross(w_auxs[i], com))
        Fs.append(pz_mul(mass_pz[i], acc_com))
        Ns.append(
            pz_matvec(inertia_pz[i], wdots[i])
            + pz_cross(w_auxs[i], pz_matvec(inertia_pz[i], ws[i]))
        )

    f = PZ.const(like.new_zeros(bt + (3,)), nval=1)
    nv = PZ.const(like.new_zeros(bt + (3,)), nval=1)
    u = [None] * spec.n_factors
    for i in range(n - 1, -1, -1):
        Rn = jrs.R[i + 1]
        com = PZ.const(_vec(spec.com[i], like), nval=1)
        Pn = PZ.const(_vec(spec.trans[i + 1], like), nval=1)
        Rf = pz_matvec(Rn, f)
        nv = Ns[i] + pz_matvec(Rn, nv) + pz_cross(com, Fs[i]) + pz_cross(Pn, Rf)
        f = Rf + Fs[i]
        if spec.axes[i] != 0:
            a = abs(int(spec.axes[i])) - 1
            sgn = 1.0 if spec.axes[i] > 0 else -1.0
            ui = pz_component(nv, a).scale(sgn)
            if include_actuation:
                ui = ui + jrs.qdda_des[i].scale(float(spec.armature[i]))
                ui = ui + jrs.qd_des[i].scale(float(spec.damping[i]))
            u[i] = ui
    return u


def grasp_constraint_pzs(spec: RobotSpec, grasp, ws, w_auxs, wdots, accs) -> tuple:
    """Contact-constraint PZs for an object carried on the last link
    (see GraspConfig; surface normal assumed +z of the end-effector frame,
    matching the reference's stated convention, `uarmtd_planner.m:545`).

    Returns (separation, slipping, tipping) scalar PZs, feasible iff
    sliced center + radius <= 0."""
    i = spec.n_joints - 1
    like = accs[i].c
    c_obj = PZ.const(_vec(grasp.object_com, like), nval=1)
    acc_obj = accs[i] + pz_cross(wdots[i], c_obj) + pz_cross(ws[i], pz_cross(w_auxs[i], c_obj))
    F = acc_obj.scale(grasp.object_mass)
    I_o = PZ.const(_vec(np.diag(grasp.object_inertia_diag), like), nval=2)
    N = pz_matvec(I_o, wdots[i]) + pz_cross(w_auxs[i], pz_matvec(I_o, ws[i]))

    Fx, Fy, Fz = (pz_component(F, a) for a in range(3))
    Nx, Ny, _ = (pz_component(N, a) for a in range(3))
    sep = -Fz
    slip = pz_mul(Fx, Fx) + pz_mul(Fy, Fy) - pz_mul(Fz, Fz).scale(grasp.u_s**2)
    tip = pz_mul(Nx, Nx) + pz_mul(Ny, Ny) - pz_mul(Fz, Fz).scale(grasp.surf_rad**2)
    return (sep.reduce(), slip.reduce(), tip.reduce())


def build_reachable_sets(spec: RobotSpec, cfg: PlannerConfig, jrs: BezierJRS,
                         grasp=None) -> ArmReachableSets:
    """Full reachable-set phase: FK + nominal torque + disturbance-driven
    torque radius (reference §II.B-II.C, `armour_main.cu:110-211`).
    ``grasp``: optional GraspConfig; its contact constraints need the
    forward recursion even when ``cfg.input_constraints`` is off."""
    link_pz, link_gens = pz_forward_kinematics(spec, jrs)
    like = jrs.R[0].c
    bt = like.shape[:2]

    if not cfg.input_constraints and grasp is None:
        return ArmReachableSets(link_pz, link_gens, [], like.new_zeros(bt + (spec.n_factors,)))

    ws, w_auxs, wdots, accs = _pz_rnea_forward(spec, jrs)
    grasp_cons = () if grasp is None else grasp_constraint_pzs(spec, grasp, ws, w_auxs, wdots, accs)
    if not cfg.input_constraints:
        return ArmReachableSets(link_pz, link_gens, [], like.new_zeros(bt + (spec.n_factors,)),
                                grasp_cons)

    scalar = like.new_zeros(())
    mass_nom = [PZ.const(_vec(spec.mass[i], like)) for i in range(spec.n_joints)]
    I_nom = [PZ.const(_vec(spec.inertia[i], like), nval=2) for i in range(spec.n_joints)]
    u_nom = _pz_rnea_backward(spec, jrs, ws, w_auxs, wdots, accs, mass_nom, I_nom,
                              include_actuation=True)

    # disturbance pass: zero-centered interval inertial params
    mass_d = [PZ.const(scalar, r=spec.mass_uncertainty * abs(spec.mass[i]))
              for i in range(spec.n_joints)]
    I_d = [
        PZ.const(like.new_zeros((3, 3)), nval=2,
                 r=spec.inertia_uncertainty * _vec(spec.inertia[i], like).abs())
        for i in range(spec.n_joints)
    ]
    u_dist = _pz_rnea_backward(spec, jrs, ws, w_auxs, wdots, accs, mass_d, I_d,
                               include_actuation=False)

    # total control-input radius (armour_main.cu:176-211):
    #   alpha (M_max - M_min) eps + 0.5 |Phi_i| + 0.5 ||Phi|| + r(u_nom) + friction
    phi_lo, phi_hi = [], []
    for i in range(spec.n_factors):
        lo, hi = u_dist[i].to_interval()
        phi_lo.append(lo)
        phi_hi.append(hi)
    phi_lo = torch.stack(phi_lo, dim=-1)   # (B, T, nf)
    phi_hi = torch.stack(phi_hi, dim=-1)
    phi_sup = torch.maximum(phi_lo.abs(), phi_hi.abs())
    rho_max = torch.sqrt(torch.sum(phi_sup**2, dim=-1, keepdim=True))

    u_nom_red = [u.reduce() for u in u_nom]
    u_nom_rad = torch.stack([u.r for u in u_nom_red], dim=-1)  # (B, T, nf)

    torque_radius = (
        spec.alpha * (spec.m_max_eig - spec.m_min_eig) * spec.ultimate_bound
        + 0.5 * phi_sup
        + 0.5 * rho_max
        + u_nom_rad
        + _vec(spec.friction[: spec.n_factors], like)
        + cfg.torque_numeric_slack
    )

    return ArmReachableSets(link_pz, link_gens, u_nom_red, torque_radius, grasp_cons)
