"""iLQR low-level tracking controller
(`simulator/agents/low_level_controllers/robot_arm_iLQR_LLC.m` role).

Port of `armour_tpu/control/ilqr.py`: a time-varying LQR around the
reference trajectory.  Because the planner's references are dynamically
feasible, the iLQR backward pass around that nominal converges in a single
sweep, so the controller IS one iLQR iteration:

1. linearize the manipulator dynamics x' = [qd, M(q)^-1 (u - bias)] about
   (x_ref(t), u_ff(t)) at ``dt_knot``-spaced knots (forward-mode autodiff,
   all worlds and knots as one batch),
2. discrete Riccati recursion backward over the knots (a Python loop,
   batched over worlds),
3. at control time, u = u_ff(t) - K(t) [q - q_des; qd - qd_des] with the
   feedforward evaluated on the CONTINUOUS reference.

Unlike the robust CBF law this carries no disturbance bound: it is a
comparison baseline (like nominal/PID).
"""

from __future__ import annotations

import torch

from armour_tpu_torch.control.robust import _position_error
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.dynamics.rnea import LinkConstants, bias_forces, link_constants, mass_matrix, rnea
from armour_tpu_torch.planner.nlp import jacobian_t
from armour_tpu_torch.robots.spec import RobotSpec


def tvlqr_gain_schedule(
    spec: RobotSpec,
    traj_eval_fn,
    t_move: float,
    dt_knot: float = 0.01,
    q_weight: float = 2500.0,
    qd_weight: float = 100.0,
    r_weight: float = 1e-2,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """Backward-pass gains K: (..., N, nf, 2 nf) at knot times i * dt_knot,
    and the feedforward torques (..., N, nf).

    ``traj_eval_fn(t) -> (q_des, qd_des, qdd_des)``, each (..., nf): a
    closure over the active TrajParams (any trajectory family), called with
    a 0-d time tensor on ``device``.  Linearization uses the NOMINAL model
    (the controller does not know the true parameters).
    """
    dev = resolve_device(device)
    nf = spec.n_factors
    n_knots = max(1, int(round(t_move / dt_knot)))
    ts = torch.arange(n_knots + 1, dtype=dtype, device=dev) * dt_knot

    refs = [traj_eval_fn(t) for t in ts]
    q_ref, qd_ref, qdd_ref = (torch.stack([r[j] for r in refs], dim=-2) for j in range(3))
    consts = link_constants(spec, q_ref)
    u_ff = rnea(spec, q_ref, qd_ref, qd_ref, qdd_ref, use_gravity=True, use_armature=True,
                consts=consts)

    lead = q_ref.shape[:-2]
    x = torch.cat([q_ref[..., :-1, :], qd_ref[..., :-1, :]], dim=-1).reshape(-1, 2 * nf)
    u = u_ff[..., :-1, :].reshape(-1, nf)

    def f(xx):
        q, qd = xx[..., :nf], xx[..., nf:]
        M = mass_matrix(spec, q, include_armature=True, consts=consts)
        b = bias_forces(spec, q, qd, consts=consts)
        return torch.cat([qd, torch.linalg.solve(M, u - b)], dim=-1)

    # every row of x is its own (world, knot): one tangent per coordinate,
    # the same in every row, gives each row's (2nf, 2nf) block, in memory
    # linear in the rows (a Jacobian of the sum over rows would push a
    # tangent per row and coordinate)
    Jx = jacobian_t(f, x).transpose(-1, -2)                           # (rows, 2nf, 2nf)
    Minv = torch.linalg.inv(mass_matrix(spec, x[..., :nf], include_armature=True, consts=consts))
    eye = torch.eye(2 * nf, dtype=dtype, device=dev)
    A_all = (eye + dt_knot * Jx).reshape(lead + (n_knots, 2 * nf, 2 * nf))
    B_all = (dt_knot * torch.cat([torch.zeros_like(Minv), Minv], dim=-2)
             ).reshape(lead + (n_knots, 2 * nf, nf))

    Q = torch.diag(torch.cat([torch.full((nf,), q_weight, dtype=dtype, device=dev),
                              torch.full((nf,), qd_weight, dtype=dtype, device=dev)]))
    Rw = r_weight * torch.eye(nf, dtype=dtype, device=dev)

    P = Q.expand(lead + (2 * nf, 2 * nf))
    Ks = [None] * n_knots
    for j in range(n_knots - 1, -1, -1):
        A, B = A_all[..., j, :, :], B_all[..., j, :, :]
        BtP = B.transpose(-1, -2) @ P
        K = torch.linalg.solve(Rw + BtP @ B, BtP @ A)                 # (..., nf, 2nf)
        Acl = A - B @ K
        # Joseph-form propagation keeps P symmetric PSD in f32
        P_new = Q + K.transpose(-1, -2) @ Rw @ K + Acl.transpose(-1, -2) @ P @ Acl
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        Ks[j] = K
    return torch.stack(Ks, dim=-3), u_ff[..., :-1, :]


def ilqr_control(
    spec: RobotSpec,
    q,
    qd,
    q_des,
    qd_des,
    qdd_des,
    K,
    wrap_continuous: bool = True,
    consts: LinkConstants | None = None,
):
    """Apply one TVLQR knot gain K (..., nf, 2nf): u = u_ff - K [e_q; e_qd],
    with u_ff the inverse dynamics along the CONTINUOUS reference at this
    instant.  Returns (u, u_ff, v = feedback part): the LLC triple shape."""
    e = _position_error(spec, q, q_des, wrap_continuous, consts)
    de = qd - qd_des
    u_ff = rnea(spec, q_des, qd_des, qd_des, qdd_des, use_gravity=True, use_armature=True,
                consts=consts)
    v = -torch.matmul(K, torch.cat([e, de], dim=-1).unsqueeze(-1)).squeeze(-1)
    return u_ff + v, u_ff, v
