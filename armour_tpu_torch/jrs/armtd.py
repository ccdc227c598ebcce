"""ARMTD 'orig' trajectory parameterization (comparison planner).

Port of `armour_tpu/jrs/armtd.py`, with the world axis B in front:
constant-acceleration trajectories q = q0 + qd0 t + 1/2 k_a t^2 over
[0, t_plan], followed by a constant-deceleration brake to rest at t_total
(`..._comparison/Trajectory.h:6-60`).  Per-joint parameter range
g_k = clamp(|qd0|/3, pi/24, pi/3) (`create_jrs_online.m:77`), so
``k_range`` depends on the data and is (B, nf) here, not (nf,).

The cos/sin PZs are constructed online with the same interval-Taylor
machinery as the Bezier JRS.  ARMTD mode has no torque constraints and no
tracking-error sets (`..._comparison/NLPclass.cu:42-54`).

The extrema are differentiated with ``torch.func`` by the NLP, so a clip is
written as ``minimum(maximum(.))`` (a tie splits the gradient, as
``jnp.clip`` does).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.device import const
from armour_tpu_torch.jrs.bezier import cos_sin_pz_terms
from armour_tpu_torch.ops.pz import PZ, pz_transpose, rot_from_cos_sin
from armour_tpu_torch.robots.spec import RobotSpec

PI = math.pi


def armtd_k_range(qd0: torch.Tensor, lo: float = PI / 24, hi: float = PI / 3) -> torch.Tensor:
    """g_k = clamp(|qd0| / 3, pi/24, pi/3) (create_jrs_online.m:77)."""
    return torch.clamp(qd0.abs() / 3.0, lo, hi)


def armtd_ref(q0, qd0, k_actual, t, t_plan: float, t_total: float):
    """(q, qd, qdd) of the peak-and-brake trajectory; t clamps to rest.
    ``t`` is a number or a tensor that broadcasts against the joint vectors."""
    tb = t_total - t_plan
    qd_pk = qd0 + k_actual * t_plan
    a_br = -qd_pk / tb
    t = torch.clamp(torch.as_tensor(t, dtype=q0.dtype, device=q0.device), 0.0, t_total)
    tau = torch.clamp(t - t_plan, min=0.0)
    t1 = torch.clamp(t, max=t_plan)
    q = q0 + qd0 * t1 + 0.5 * k_actual * t1**2 + qd_pk * tau + 0.5 * a_br * tau**2
    qd = torch.where(t <= t_plan, qd0 + k_actual * t, qd_pk + a_br * tau)
    qdd = torch.where(t <= t_plan, k_actual, a_br)
    return q, qd, qdd


@dataclasses.dataclass(frozen=True)
class ArmtdJRS:
    """Same consumer interface as BezierJRS for the FK path; PZ batch (B, T)."""

    q0: torch.Tensor       # (B, nf)
    qd0: torch.Tensor
    k_range: torch.Tensor  # (B, nf) g_k per joint (data-dependent!)
    t_plan: float
    t_total: float

    cos_q: list
    sin_q: list
    R: list
    R_t: list


def _phase_terms(q0, qd0, g_k, t, t_plan, tb):
    """A(t), B(t) with q(t, k) = A + k * B (exact in both phases)."""
    tau = torch.clamp(t - t_plan, min=0.0)
    t1 = torch.clamp(t, max=t_plan)
    ramp = tau - tau**2 / (2.0 * tb)
    A = q0 + qd0 * t1 + qd0 * ramp
    B = g_k * (0.5 * t1**2 + t_plan * ramp)
    return A, B


def make_armtd_jrs(spec: RobotSpec, cfg: PlannerConfig, q0: torch.Tensor,
                   qd0: torch.Tensor) -> ArmtdJRS:
    """q0, qd0: (B, nf) on the target device and dtype."""
    nf = spec.n_factors
    T = cfg.num_time_steps
    t_plan = cfg.t_plan
    t_total = cfg.duration
    tb = t_total - t_plan
    dtype, dev = q0.dtype, q0.device
    g_k = armtd_k_range(qd0)

    ts = torch.linspace(0.0, t_total, T + 1, dtype=torch.float64, device=dev).to(dtype)
    t_lo = ts[:-1][None, :, None]  # (1, T, 1)
    t_hi = ts[1:][None, :, None]
    q0b, qd0b, g_kb = q0[:, None], qd0[:, None], g_k[:, None]

    # A monotone in t within each phase (sign of qd0); B non-decreasing.
    # NUM_TIME_STEPS even => no subinterval straddles t_plan.
    A_lo, B_lo = _phase_terms(q0b, qd0b, g_kb, t_lo, t_plan, tb)
    A_hi, B_hi = _phase_terms(q0b, qd0b, g_kb, t_hi, t_plan, tb)
    A_min = torch.minimum(A_lo, A_hi)
    A_max = torch.maximum(A_lo, A_hi)
    q_center = 0.5 * (A_min + A_max)                 # (B, T, nf)
    q_rad = 0.5 * (A_max - A_min)
    kc = 0.5 * (B_lo + B_hi)
    q_rad = q_rad + 0.5 * (B_hi - B_lo).abs()        # k-coeff variation over interval

    cos_c, cos_k, cos_r, sin_c, sin_k, sin_r = cos_sin_pz_terms(q_center, kc, q_rad)

    fixed = spec.fixed_rotations()
    bt = (q0.shape[0], T)
    cos_q, sin_q, R_list, Rt_list = [], [], [], []
    for i in range(nf):
        key = ((i, 1),)
        cos_q.append(PZ.from_gens(cos_c[..., i], [key], [cos_k[..., i]], r=cos_r[..., i], nval=0))
        sin_q.append(PZ.from_gens(sin_c[..., i], [key], [sin_k[..., i]], r=sin_r[..., i], nval=0))
        R_i = rot_from_cos_sin(cos_q[i], sin_q[i], int(spec.axes[i]), fixed[i])
        R_list.append(R_i)
        Rt_list.append(pz_transpose(R_i))
    for i in range(nf, spec.n_joints):
        Rf = PZ.const(const(fixed[i], dtype, dev).expand(bt + (3, 3)), nval=2)
        R_list.append(Rf)
        Rt_list.append(pz_transpose(Rf))
    R_list.append(PZ.const(torch.eye(3, dtype=dtype, device=dev).expand(bt + (3, 3)), nval=2))

    return ArmtdJRS(q0=q0, qd0=qd0, k_range=g_k, t_plan=t_plan, t_total=t_total,
                    cos_q=cos_q, sin_q=sin_q, R=R_list, R_t=Rt_list)


def _clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi) with its gradient convention (see module doc)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def armtd_position_extrema(q0, qd0, k_range, k, t_plan: float, t_total: float):
    """(min, max) of q over [0, t_total], differentiable in k.  Elementwise
    over joints; every tensor argument broadcasts.

    Candidates: t = 0; the interior stationary point t* = -qd0 / k_a of
    phase 1; the terminal rest position (phase 2 is monotone).
    """
    ka = k_range * k
    tp = t_plan
    tb = t_total - tp
    qd_pk = qd0 + ka * tp

    v0 = q0 + torch.zeros_like(ka)
    v_end = q0 + qd0 * tp + 0.5 * ka * tp**2 + 0.5 * qd_pk * tb

    ka_safe = torch.where(ka.abs() > 1e-12, ka, 1e-12)
    t_star = -qd0 / ka_safe
    ok = (ka.abs() > 1e-12) & (t_star > 0.0) & (t_star < tp)
    t_c = _clip(t_star, 0.0, tp)
    v_star = q0 + qd0 * t_c + 0.5 * ka * t_c**2
    big = 1e30
    mn = torch.minimum(torch.minimum(v0, v_end), torch.where(ok, v_star, big))
    mx = torch.maximum(torch.maximum(v0, v_end), torch.where(ok, v_star, -big))
    return mn, mx


def armtd_velocity_extrema(qd0, k_range, k, t_plan: float):
    """qd is piecewise linear: extrema at t = 0 and t = t_plan."""
    ka = k_range * k
    qd_pk = qd0 + ka * t_plan
    zero = torch.zeros_like(qd_pk)
    mn = torch.minimum(torch.minimum(qd0 + zero, qd_pk), zero)
    mx = torch.maximum(torch.maximum(qd0 + zero, qd_pk), zero)
    return mn, mx
