"""Frozen copy of ``armour_tpu_torch/dynamics/rnea.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Numeric modified (passivity) RNEA, point and interval versions, and
point forward kinematics.

Port of `armour_tpu/dynamics/rnea.py`.  The joint chain is unrolled in
Python (7 iterations); all state is (..., 3) tensors that broadcast over
arbitrary leading batch dimensions.  The "modified" recursion carries an
auxiliary velocity w_aux (the passivity controller's reference velocity)
and reduces to classic RNEA when qd_aux == qd.

Eager PyTorch launches one device kernel per tensor operation, so the
functions here are written for few operations: all joint rotations as one
batched product, the joint-rate vectors and the torque assembly for all
joints at once, one fused cross-product call per cross, and no in-place
writes (``torch.func.jacfwd`` differentiates through them).  Two optional
arguments let a caller that runs many passes hoist shared work:

- ``consts``: the per-link constants as device tensors (``link_constants``),
  made once instead of copied from the spec's numpy arrays on every call;
- ``R``: the joint rotations of ``q`` (``joint_rotations``), computed once
  per evaluation point and shared by every pass at that point.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from armour_bench.reference.device import const
from armour_bench.reference.interval import Interval
from armour_bench.reference.spec import RobotSpec


def _rotation_masks(spec: RobotSpec) -> np.ndarray:
    """(3, n_joints + 1, 3, 3): where cos(q_i), where +-sin(q_i) and where
    the constant 1 go in R(axis_i, q_i), axis in {+-1, +-2, +-3} (rx/ry/rz);
    fixed joints and the end-effector frame are the identity."""
    n = spec.n_joints
    m = np.zeros((3, n + 1, 3, 3))
    for i in range(n + 1):
        axis = int(spec.axes[i]) if i < n else 0
        if axis == 0:
            m[2, i] = np.eye(3)
            continue
        a, sgn = abs(axis) - 1, (1.0 if axis > 0 else -1.0)
        j, k = (a + 1) % 3, (a + 2) % 3
        m[0, i, j, j] = m[0, i, k, k] = 1.0
        m[1, i, k, j], m[1, i, j, k] = sgn, -sgn
        m[2, i, a, a] = 1.0
    return m


def joint_rotations(spec: RobotSpec, q: torch.Tensor, consts: "LinkConstants | None" = None) -> torch.Tensor:
    """Per-joint rotation R_i (frame i in frame i-1): (..., n_joints+1, 3, 3),
    all joints in one batched product: R_i = F_i (c_i C_i + s_i S_i + K_i)
    with 0/+-1 masks, so every entry is exactly cos, +-sin, 0 or 1 before the
    fixed rotation F_i.  ``consts`` (``link_constants``) holds F and the masks
    as device tensors, so a loop does not copy them from the host on every
    call."""
    if consts is None:
        fixed = const(spec.fixed_rotations(), q.dtype, q.device)
        masks = const(_rotation_masks(spec), q.dtype, q.device)
    else:
        fixed, masks = consts.fixed, consts.rot_masks
    nf = spec.n_factors
    c = torch.cos(q)[..., None, None]
    s = torch.sin(q)[..., None, None]
    R = torch.matmul(fixed[:nf], c * masks[0, :nf] + s * masks[1, :nf] + masks[2, :nf])
    # trailing fixed joints and the identity end-effector frame
    tail = fixed[nf:].expand(q.shape[:-1] + (spec.n_joints + 1 - nf, 3, 3))
    return torch.cat([R, tail], dim=-3)


def forward_kinematics(spec: RobotSpec, q: torch.Tensor):
    """World-frame (R_w, p_w) per joint frame: ((..., n, 3, 3), (..., n, 3)).

    Matches the accumulation in `Dynamics.cu:69-81` (p is the joint frame
    origin; link volumes are R_w @ link_zono + p).
    """
    R = joint_rotations(spec, q)
    trans = const(spec.trans, q.dtype, q.device)
    Rw = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3))
    pw = q.new_zeros(q.shape[:-1] + (3,))
    Rws, pws = [], []
    for i in range(spec.n_joints):
        pw = pw + torch.einsum("...ab,b->...a", Rw, trans[i])
        Rw = torch.einsum("...ab,...bc->...ac", Rw, R[..., i, :, :])
        Rws.append(Rw)
        pws.append(pw)
    return torch.stack(Rws, dim=-3), torch.stack(pws, dim=-2)


class LinkConstants(NamedTuple):
    """Per-link constants of a spec as tensors on one device and dtype.
    ``mass`` and ``inertia`` may carry leading batch dims (the plant's true
    parameters of B worlds): (..., n) and (..., n, 3, 3)."""

    fixed: torch.Tensor     # (n + 1, 3, 3) fixed frame rotations
    rot_masks: torch.Tensor  # (3, n + 1, 3, 3) cos / sin / constant masks of the joint rotations
    axes: torch.Tensor      # (nf, 3) signed unit rotation axes of the actuated joints
    continuous: torch.Tensor  # (nf,) bool: joints without position limits
    trans: torch.Tensor     # (n + 1, 3)
    com: torch.Tensor       # (n, 3)
    mass: torch.Tensor      # (..., n)
    inertia: torch.Tensor   # (..., n, 3, 3)
    armature: torch.Tensor  # (n,)
    damping: torch.Tensor   # (n,)
    eye3: torch.Tensor      # (3, 3)


def link_constants(spec: RobotSpec, like: torch.Tensor, mass=None, com=None,
                   inertia=None) -> LinkConstants:
    """The spec's constants on the device and dtype of ``like``; ``mass``,
    ``com`` and ``inertia`` override the nominal values (arrays or tensors).
    Host data comes through `device.const` (made once, so a captured step
    may call this)."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return torch.as_tensor(x, dtype=like.dtype, device=like.device)
        return const(x, like.dtype, like.device)

    return LinkConstants(
        fixed=t(spec.fixed_rotations()),
        rot_masks=t(_rotation_masks(spec)),
        axes=t(np.sign(spec.axes[:spec.n_factors, None])
               * np.eye(3)[np.abs(spec.axes[:spec.n_factors]) - 1]),
        continuous=const(spec.continuous_joints, device=like.device),
        trans=t(spec.trans),
        com=t(spec.com if com is None else com),
        mass=t(spec.mass if mass is None else mass),
        inertia=t(spec.inertia if inertia is None else inertia),
        armature=t(spec.armature),
        damping=t(spec.damping),
        eye3=torch.eye(3, dtype=like.dtype, device=like.device),
    )


def _rot(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v over broadcast batch dims: (..., 3, 3), (..., 3) -> (..., 3).
    One constant matrix goes through a plain product v M^T, which needs no
    expanded copy of M."""
    if M.ndim == 2:
        return torch.matmul(v, M.transpose(-1, -2))
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b as one fused call; a constant 3-vector is expanded (a view)
    because ``linalg.cross`` wants equal ranks."""
    if a.ndim != b.ndim:
        a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _abs_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise majorant |a x b| <= |a| x~ |b| for non-negative a, b."""
    return a.roll(-1, -1) * b.roll(-2, -1) + a.roll(-2, -1) * b.roll(-1, -1)


def _forward_pass(spec: RobotSpec, q, qd, qd_aux, qdd, use_gravity,
                  consts: LinkConstants, R=None):
    """Velocity/acceleration recursion (inertia-free).

    ``use_gravity`` is a bool, or a 0/1 tensor that broadcasts against the
    batch dims and switches gravity per row (one stacked pass for the mass
    matrix columns, without gravity, and the bias forces, with it).

    Returns per-joint lists (w, w_aux, wdot, acc, R), shared by the point
    and interval backward passes (torque is linear in inertial params, so
    the forward pass never needs interval arithmetic for inertia
    uncertainty).  Mirrors `Dynamics.cu:101-155` ordering exactly.
    """
    if R is None:
        R = joint_rotations(spec, q, consts)
    batch = torch.broadcast_shapes(q.shape, qd.shape, qd_aux.shape, qdd.shape)[:-1]
    e = consts.eye3
    zero3 = q.new_zeros(batch + (3,))
    w, w_aux, wdot = zero3, zero3, zero3
    if isinstance(use_gravity, torch.Tensor):
        acc = (use_gravity[..., None] * (e[2] * spec.gravity)).expand(batch + (3,))
    else:
        acc = (e[2] * spec.gravity).expand(batch + (3,)) if use_gravity else zero3

    # joint-rate vectors of all actuated joints at once: (..., nf, 3)
    z_qd = qd[..., None] * consts.axes
    z_qda = qd_aux[..., None] * consts.axes
    z_qdd = qdd[..., None] * consts.axes
    ws, w_auxs, wdots, accs = [], [], [], []
    for i in range(spec.n_joints):
        Rt = R[..., i, :, :].transpose(-1, -2)
        P = consts.trans[i]
        acc = _rot(Rt, acc + _cross(wdot, P) + _cross(w, _cross(w_aux, P)))
        w = _rot(Rt, w)
        w_aux = _rot(Rt, w_aux)
        wdot = _rot(Rt, wdot)
        if spec.axes[i] != 0:
            w = w + z_qd[..., i, :]
            wdot = wdot + _cross(w_aux, z_qd[..., i, :]) + z_qdd[..., i, :]
            w_aux = w_aux + z_qda[..., i, :]
        ws.append(w)
        w_auxs.append(w_aux)
        wdots.append(wdot)
        accs.append(acc)
    return ws, w_auxs, wdots, accs, R


def _backward_pass(spec: RobotSpec, ws, w_auxs, wdots, accs, R, qd, qdd,
                   consts: LinkConstants, use_armature: bool):
    """Force recursion with the inertial params of ``consts`` -> joint
    torques (..., nf)."""
    n = spec.n_joints
    Fs, Ns = [], []
    for i in range(n):
        ci = consts.com[i]
        acc_com = accs[i] + _cross(wdots[i], ci) + _cross(ws[i], _cross(w_auxs[i], ci))
        Fs.append(consts.mass[..., i, None] * acc_com)
        I = consts.inertia[..., i, :, :]
        Ns.append(_rot(I, wdots[i]) + _cross(w_auxs[i], _rot(I, ws[i])))

    f = torch.zeros_like(Fs[0])
    nn = torch.zeros_like(Fs[0])
    moments = []
    for i in range(n - 1, -1, -1):
        Rn = R[..., i + 1, :, :]
        Rf = _rot(Rn, f)
        nn = (Ns[i] + _rot(Rn, nn)
              + _cross(consts.com[i], Fs[i]) + _cross(consts.trans[i + 1], Rf))
        f = Rf + Fs[i]
        if spec.axes[i] != 0:
            moments.append(nn)
    moments.reverse()
    # the moment about each joint's (signed) axis, then the actuator terms,
    # for all joints at once
    nf = spec.n_factors
    u = torch.sum(torch.stack(moments, dim=-2) * consts.axes, dim=-1)
    if use_armature:
        u = u + consts.armature[:nf] * qdd
    return u + consts.damping[:nf] * qd


def rnea(spec: RobotSpec, q, qd, qd_aux, qdd, use_gravity=True,
         mass=None, com=None, inertia=None, use_armature: bool = True,
         consts: LinkConstants | None = None, R=None):
    """Point modified RNEA -> joint torques (..., n_factors).

    Defaults to nominal inertial params; pass overrides for the plant's
    "true" params (cf. `uarmtd_agent.m:385-424`), either as ``mass``/
    ``com``/``inertia`` or ready-made in ``consts``.
    """
    if consts is None:
        consts = link_constants(spec, q, mass, com, inertia)
    ws, w_auxs, wdots, accs, R = _forward_pass(spec, q, qd, qd_aux, qdd, use_gravity, consts, R)
    return _backward_pass(spec, ws, w_auxs, wdots, accs, R, qd, qdd, consts, use_armature)


def rnea_with_bound(spec: RobotSpec, q, qd, qd_aux, qdd, use_gravity: bool = True,
                    mass_scale: tuple[float, float] | None = None,
                    use_armature: bool = True, consts: LinkConstants | None = None,
                    R=None):
    """Nominal modified RNEA torque and the bound |delta torque| over the
    spec's inertial uncertainty: (u_nom, du), each (..., n_factors).

    Because torque is linear in the inertial parameters and the forward
    recursion does not involve them, du is one backward pass with delta
    params on absolute values: exact and cheaper than a full interval
    recursion (cf. `rnea.cpp` passRNEA_Int).  The forward pass is run once
    and shared by the nominal and the delta pass.

    ``mass_scale`` optionally overrides the mass uncertainty range (the
    controller benchmark sweeps it, `kinova_compare_robust_controller.m:18`).
    ``consts`` holds the NOMINAL parameters.
    """
    if consts is None:
        consts = link_constants(spec, q)
    if mass_scale is None:
        dm = spec.mass_uncertainty
    else:
        dm = max(abs(mass_scale[0] - 1.0), abs(mass_scale[1] - 1.0))
    dI = spec.inertia_uncertainty if mass_scale is None else dm

    ws, w_auxs, wdots, accs, R = _forward_pass(spec, q, qd, qd_aux, qdd, use_gravity, consts, R)
    u_nom = _backward_pass(spec, ws, w_auxs, wdots, accs, R, qd, qdd, consts, use_armature)
    n = spec.n_joints

    # propagate absolute values through the linear backward recursion with
    # delta params dm*m, dI*|I|
    abs_com = consts.com.abs()
    abs_trans = consts.trans.abs()
    abs_inertia = consts.inertia.abs()
    absF, absN = [], []
    for i in range(n):
        ci = consts.com[i]
        acc_com = accs[i] + _cross(wdots[i], ci) + _cross(ws[i], _cross(w_auxs[i], ci))
        absF.append((dm * consts.mass[..., i, None]) * acc_com.abs())
        absI = dI * abs_inertia[..., i, :, :]
        Iw = _rot(absI, ws[i].abs())
        Iwd = _rot(absI, wdots[i].abs())
        absN.append(Iwd + _abs_cross(w_auxs[i].abs(), Iw))

    f = torch.zeros_like(absF[0])
    nn = torch.zeros_like(absF[0])
    du = []
    for i in range(n - 1, -1, -1):
        Rn = R[..., i + 1, :, :].abs()
        Rf = _rot(Rn, f)
        nn = (absN[i] + _rot(Rn, nn)
              + _abs_cross(abs_com[i], absF[i]) + _abs_cross(abs_trans[i + 1], Rf))
        f = Rf + absF[i]
        if spec.axes[i] != 0:
            du.append(nn[..., abs(int(spec.axes[i])) - 1])
    du.reverse()
    return u_nom, torch.stack(du, dim=-1)


def rnea_interval(spec: RobotSpec, q, qd, qd_aux, qdd, use_gravity: bool = True,
                  mass_scale: tuple[float, float] | None = None,
                  use_armature: bool = True, consts: LinkConstants | None = None,
                  R=None) -> Interval:
    """Interval modified RNEA over the spec's inertial uncertainty:
    nominal +/- ``rnea_with_bound``'s bound, an Interval over (..., n_factors)."""
    u_nom, du = rnea_with_bound(spec, q, qd, qd_aux, qdd, use_gravity, mass_scale,
                                use_armature, consts, R)
    return Interval(u_nom - du, u_nom + du)


def mass_matrix(spec: RobotSpec, q, include_armature: bool = True,
                consts: LinkConstants | None = None, R=None):
    """M(q) via n RNEA columns (qd=0, qdd=e_i, no gravity), the standard
    inverse-dynamics trick, stacked into ONE pass with a leading axis of n:
    (..., nf, nf)."""
    nf = spec.n_factors
    eye = torch.eye(nf, dtype=q.dtype, device=q.device)
    qdd = eye.reshape((nf,) + (1,) * (q.ndim - 1) + (nf,))      # (nf, 1.., nf)
    zero = torch.zeros_like(q)
    cols = rnea(spec, q, zero, zero, qdd, use_gravity=False, use_armature=include_armature,
                consts=consts, R=R)                               # (nf cols, ..., nf rows)
    return cols.movedim(0, -1)


def bias_forces(spec: RobotSpec, q, qd, consts: LinkConstants | None = None, R=None):
    """C(q, qd) qd + g(q) via RNEA with qdd = 0."""
    return rnea(spec, q, qd, qd, torch.zeros_like(q), use_gravity=True, use_armature=False,
                consts=consts, R=R)
