"""Frozen copy of ``armour_tpu_torch/jrs/bezier.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Online Bezier joint reachable sets (JRS).

Port of `armour_tpu/jrs/bezier.py`: every quantity is a closed-form tensor
over all worlds, T subintervals and joints at once, packed into batched
static-basis PZs with batch ``(B, T)``.

Trajectory parameterization (`Trajectory.h:10-31`): per joint a degree-5
Bezier over normalized time s in [0, 1] that starts at (q0, qd0, qdd0) and
ends at (q0 + k * k_range, 0, 0).  Tracking-error variables are folded into
the PZ radius at construction.

The extrema functions are differentiated with ``torch.func`` by the NLP,
so they keep the reference's gradient conventions: a clip is written as
``minimum(maximum(.))`` (a tie splits the gradient, as ``jnp.clip`` does;
``torch.clamp`` would pass it whole) and ``_safe_sqrt`` keeps its ``where``
form.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from armour_bench.reference.config import PlannerConfig
from armour_bench.reference.device import const
from armour_bench.reference.interval import Interval, icos, isin
from armour_bench.reference.pz import PZ, pz_transpose, rot_from_cos_sin
from armour_bench.reference.spec import RobotSpec

# the k-dependent factor of qdd_des, 60 s (2s^2 - 3s + 1), has its interior
# maximum / minimum at these s values (Trajectory.h:7-8)
_QDD_K_DEP_MAXIMA = 0.5 - math.sqrt(3.0) / 6.0
_QDD_K_DEP_MINIMA = 0.5 + math.sqrt(3.0) / 6.0


# ---------------------------------------------------------------------------
# closed-form trajectory evaluation (Trajectory.cu:542-599)
# ---------------------------------------------------------------------------

def _betas(q0, Tqd0, TTqdd0, k_actual):
    """Bezier control points (shared by q/qd/qdd evaluation)."""
    b0 = q0
    b1 = q0 + Tqd0 / 5.0
    b2 = q0 + (2.0 * Tqd0) / 5.0 + TTqdd0 / 20.0
    b3 = q0 + k_actual
    return b0, b1, b2, b3


def q_des_fn(q0, Tqd0, TTqdd0, k_actual, s):
    b0, b1, b2, b3 = _betas(q0, Tqd0, TTqdd0, k_actual)
    B0 = -((s - 1.0) ** 5)
    B1 = 5.0 * s * (s - 1.0) ** 4
    B2 = -10.0 * s**2 * (s - 1.0) ** 3
    B3 = 10.0 * s**3 * (s - 1.0) ** 2
    B4 = -5.0 * s**4 * (s - 1.0)
    B5 = s**5
    return B0 * b0 + B1 * b1 + B2 * b2 + (B3 + B4 + B5) * b3


def qd_des_fn(q0, Tqd0, TTqdd0, k_actual, s):
    """d/ds of q_des (divide by DURATION for rad/s)."""
    b0, b1, b2, b3 = _betas(q0, Tqd0, TTqdd0, k_actual)
    dB0 = -5.0 * (s - 1.0) ** 4
    dB1 = 20.0 * s * (s - 1.0) ** 3 + 5.0 * (s - 1.0) ** 4
    dB2 = -20.0 * s * (s - 1.0) ** 3 - 30.0 * s**2 * (s - 1.0) ** 2
    dB3 = 10.0 * s**3 * (2.0 * s - 2.0) + 30.0 * s**2 * (s - 1.0) ** 2
    dB4 = -20.0 * s**3 * (s - 1.0) - 5.0 * s**4
    dB5 = 5.0 * s**4
    return dB0 * b0 + dB1 * b1 + dB2 * b2 + (dB3 + dB4 + dB5) * b3


def qdd_des_fn(q0, Tqd0, TTqdd0, k_actual, s):
    """d2/ds2 of q_des (divide by DURATION^2 for rad/s^2)."""
    b0, b1, b2, b3 = _betas(q0, Tqd0, TTqdd0, k_actual)
    t5 = s - 1.0
    ddB0 = -20.0 * t5**3
    ddB1 = 40.0 * t5**3 + 60.0 * s * t5**2
    ddB2 = -20.0 * t5**3 - 120.0 * s * t5**2 - 30.0 * s**2 * (2.0 * s - 2.0)
    ddB3 = 20.0 * s**3 + 60.0 * s * t5**2 + 60.0 * s**2 * (2.0 * s - 2.0)
    ddB4 = -40.0 * s**3 - 60.0 * s**2 * t5
    ddB5 = 20.0 * s**3
    return ddB0 * b0 + ddB1 * b1 + ddB2 * b2 + (ddB3 + ddB4 + ddB5) * b3


def bezier_ref(q0, qd0, qdd0, k_actual, t, duration: float = 1.0):
    """Reference (q, qd, qdd) at wall-clock time t in [0, duration].

    Broadcasts over joint vectors; this is what the low-level controller
    tracks (`uarmtd_planner.m:899-921` desired_trajectory).
    """
    s = t / duration
    Tqd0 = qd0 * duration
    TTqdd0 = qdd0 * duration * duration
    q = q_des_fn(q0, Tqd0, TTqdd0, k_actual, s)
    qd = qd_des_fn(q0, Tqd0, TTqdd0, k_actual, s) / duration
    qdd = qdd_des_fn(q0, Tqd0, TTqdd0, k_actual, s) / (duration * duration)
    return q, qd, qdd


def _q_des_k_indep(q0, Tqd0, TTqdd0, s):
    """k-independent part of q_des (Trajectory.cu:812-814)."""
    return (
        q0
        + Tqd0 * s
        - 6.0 * Tqd0 * s**3
        + 8.0 * Tqd0 * s**4
        - 3.0 * Tqd0 * s**5
        + 0.5 * TTqdd0 * s**2
        - 1.5 * TTqdd0 * s**3
        + 1.5 * TTqdd0 * s**4
        - 0.5 * TTqdd0 * s**5
    )


def _qd_des_k_indep(Tqd0, TTqdd0, s, duration):
    """(Trajectory.cu:816-818)."""
    return (
        0.5
        * (s - 1.0) ** 2
        * (2.0 * Tqd0 + 4.0 * Tqd0 * s + 2.0 * TTqdd0 * s - 30.0 * Tqd0 * s**2 - 5.0 * TTqdd0 * s**2)
        / duration
    )


def _qdd_des_k_indep(Tqd0, TTqdd0, s, duration):
    """(Trajectory.cu:820-822)."""
    return (
        -(s - 1.0)
        * (TTqdd0 - (36.0 * Tqd0 + 8.0 * TTqdd0) * s + (60.0 * Tqd0 + 10.0 * TTqdd0) * s**2)
        / (duration * duration)
    )


def _safe_sqrt(x):
    return torch.sqrt(torch.where(x > 0.0, x, 1.0))


def _clip01(x):
    """jnp.clip(x, 0, 1) with its gradient convention (see module doc)."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def cos_sin_pz_terms(q_center, kc, q_rad):
    """cos/sin PZ terms from q in q_center + kc * k + [-q_rad, q_rad],
    k in [-1, 1]: first-order Taylor with interval Lagrange remainder
    (`Trajectory.cu:101-134`)."""
    k_int = Interval(-kc.abs() - q_rad, kc.abs() + q_rad)
    rad_int = Interval(-q_rad, q_rad)
    cos_c = torch.cos(q_center)
    sin_c = torch.sin(q_center)
    cos_rem = rad_int * (-sin_c) - 0.5 * icos(k_int + q_center) * k_int.square()
    sin_rem = rad_int * cos_c - 0.5 * isin(k_int + q_center) * k_int.square()
    return (
        cos_c + cos_rem.center,
        -kc * sin_c,
        cos_rem.radius,
        sin_c + sin_rem.center,
        kc * cos_c,
        sin_rem.radius,
    )


def _range_with_extrema(endpoints_lo, endpoints_hi, extrema_s, extrema_val, s_lo, s_hi):
    """Range over [s_lo, s_hi] from endpoint values + interior extrema;
    candidates outside (s_lo, s_hi) are ignored (Trajectory.cu:80-93)."""
    lo = torch.minimum(endpoints_lo, endpoints_hi)
    hi = torch.maximum(endpoints_lo, endpoints_hi)
    for es, ev in zip(extrema_s, extrema_val):
        inside = (s_lo < es) & (es < s_hi)
        lo = torch.where(inside, torch.minimum(lo, ev), lo)
        hi = torch.where(inside, torch.maximum(hi, ev), hi)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class BezierJRS:
    """Per-joint PZs batched over (B worlds, T time subintervals).

    ``R[i]`` is the 3x3 rotation PZ of joint i; the list has n_joints + 1
    entries with an identity end-effector frame (`Trajectory.cu:247-253`).
    """

    q0: torch.Tensor       # (B, nf)
    qd0: torch.Tensor
    qdd0: torch.Tensor
    Tqd0: torch.Tensor
    TTqdd0: torch.Tensor
    k_range: torch.Tensor  # (nf,)
    duration: float

    cos_q: list            # n_factors scalar PZs, batch (B, T)
    sin_q: list
    qd_des: list           # with qde radius (for RNEA velocity slot)
    qda_des: list          # with qdae radius (auxiliary velocity)
    qdda_des: list         # with qddae radius (auxiliary acceleration)
    R: list                # n_joints + 1 rotation PZs
    R_t: list              # n_joints transposed rotation PZs


def _indep_extrema(disc, num, den, value_fn):
    """Stationary points (num +/- sqrt(disc)) / den of a k-independent
    trajectory term, -1 (outside [0, 1]) where there are none."""
    den = torch.where(den.abs() < 1e-30, 1e-30, den)
    valid = disc > 0.0
    e1 = torch.where(valid, (num + _safe_sqrt(disc)) / den, -1.0)
    e2 = torch.where(valid, (num - _safe_sqrt(disc)) / den, -1.0)
    return (e1, e2), (value_fn(e1), value_fn(e2))


def make_bezier_jrs(
    spec: RobotSpec,
    cfg: PlannerConfig,
    q0: torch.Tensor,
    qd0: torch.Tensor,
    qdd0: torch.Tensor,
) -> BezierJRS:
    """Build the full JRS for all worlds and T subintervals
    (Trajectory.cu:63-254).  q0, qd0, qdd0: (B, nf) on the target device
    and dtype."""
    nf = spec.n_factors
    T = cfg.num_time_steps
    dur = cfg.duration
    dtype, dev = q0.dtype, q0.device
    Tqd0 = qd0 * dur
    TTqdd0 = qdd0 * dur * dur
    k_rng = torch.full((nf,), cfg.k_range, dtype=dtype, device=dev)

    s_grid = torch.arange(T + 1, dtype=dtype, device=dev) / T
    s_lb = s_grid[:-1][None, :, None]  # (1, T, 1)
    s_ub = s_grid[1:][None, :, None]
    # per-world trajectory data broadcast over time: (B, 1, nf)
    q0b, Tqd0b, TTqdd0b = q0[:, None], Tqd0[:, None], TTqdd0[:, None]

    qe, qde, qdae, qddae = spec.qe, spec.qde, spec.qdae, spec.qddae

    # ---- k-independent extrema (Trajectory.cu:36-58), shape (B, 1, nf) ----
    den = 5.0 * (6.0 * Tqd0b + TTqdd0b)
    qie_s, qie_v = _indep_extrema(
        64.0 * Tqd0b**2 + 14.0 * Tqd0b * TTqdd0b + TTqdd0b**2,
        2.0 * Tqd0b + TTqdd0b, den,
        lambda e: _q_des_k_indep(q0b, Tqd0b, TTqdd0b, e))
    den = 10.0 * (6.0 * Tqd0b + TTqdd0b)
    qdie_s, qdie_v = _indep_extrema(
        6.0 * (54.0 * Tqd0b**2 + 14.0 * Tqd0b * TTqdd0b + TTqdd0b**2),
        18.0 * Tqd0b + 4.0 * TTqdd0b, den,
        lambda e: _qd_des_k_indep(Tqd0b, TTqdd0b, e, dur))
    qddie_s, qddie_v = _indep_extrema(
        2.0 * (152.0 * Tqd0b**2 + 42.0 * Tqd0b * TTqdd0b + 3.0 * TTqdd0b**2),
        32.0 * Tqd0b + 6.0 * TTqdd0b, den,
        lambda e: _qdd_des_k_indep(Tqd0b, TTqdd0b, e, dur))

    # ---- Part 1: q_des range and cos/sin PZs (Trajectory.cu:71-144) ----
    def Bk(s):
        return s**3 * (6.0 * s**2 - 15.0 * s + 10.0)

    kd_lb = Bk(s_lb)  # (1, T, 1); B monotone increasing on [0, 1]
    kd_ub = Bk(s_ub)
    kd_center = 0.5 * (kd_ub + kd_lb)
    kd_radius = 0.5 * (kd_ub - kd_lb) * k_rng       # (1, T, nf)

    qi_lo, qi_hi = _range_with_extrema(
        _q_des_k_indep(q0b, Tqd0b, TTqdd0b, s_lb),
        _q_des_k_indep(q0b, Tqd0b, TTqdd0b, s_ub),
        qie_s, qie_v, s_lb, s_ub,
    )
    qi_radius = 0.5 * (qi_hi - qi_lo)
    q_center = 0.5 * (qi_hi + qi_lo)                 # (B, T, nf)
    q_rad = kd_radius + qi_radius + qe

    kc = (kd_center * k_rng).expand(q_center.shape)  # k coeff (actual rad)
    (cos_center, cos_kcoeff, cos_radius,
     sin_center, sin_kcoeff, sin_radius) = cos_sin_pz_terms(q_center, kc, q_rad)

    fixed = spec.fixed_rotations()

    # ---- Part 2: qd_des k-dep factor (Trajectory.cu:146-192) ----
    def Bd(s):
        return 30.0 * s**2 * (s - 1.0) ** 2 / dur

    bd_a = Bd(s_lb)
    bd_b = Bd(s_ub)
    # single interior maximum at s = 0.5; T even => each subinterval is
    # monotone, so sorting the endpoint values bounds the factor
    bd_lo = torch.minimum(bd_a, bd_b)
    bd_hi = torch.maximum(bd_a, bd_b)
    qd_kc = 0.5 * (bd_hi + bd_lo) * k_rng
    qd_kr = 0.5 * (bd_hi - bd_lo) * k_rng

    qdi_lo, qdi_hi = _range_with_extrema(
        _qd_des_k_indep(Tqd0b, TTqdd0b, s_lb, dur),
        _qd_des_k_indep(Tqd0b, TTqdd0b, s_ub, dur),
        qdie_s, qdie_v, s_lb, s_ub,
    )
    qd_center = 0.5 * (qdi_hi + qdi_lo)
    qd_ir = 0.5 * (qdi_hi - qdi_lo)

    # ---- Part 3: qdd_des k-dep factor (Trajectory.cu:194-244) ----
    def Bdd(s):
        return 60.0 * s * (2.0 * s**2 - 3.0 * s + 1.0) / (dur * dur)

    t_lb = Bdd(s_lb)
    t_ub = Bdd(s_ub)
    bmax = Bdd(const(_QDD_K_DEP_MAXIMA, dtype, dev))
    bmin = Bdd(const(_QDD_K_DEP_MINIMA, dtype, dev))
    lo_mono = torch.minimum(t_lb, t_ub)
    hi_mono = torch.maximum(t_lb, t_ub)
    has_max = (s_lb <= _QDD_K_DEP_MAXIMA) & (_QDD_K_DEP_MAXIMA < s_ub)
    has_min = (s_lb <= _QDD_K_DEP_MINIMA) & (_QDD_K_DEP_MINIMA < s_ub)
    bdd_lo = torch.where(has_min, bmin, lo_mono)
    bdd_hi = torch.where(has_max, bmax, hi_mono)
    qdd_kc = 0.5 * (bdd_hi + bdd_lo) * k_rng
    qdd_kr = 0.5 * (bdd_hi - bdd_lo) * k_rng

    qddi_lo, qddi_hi = _range_with_extrema(
        _qdd_des_k_indep(Tqd0b, TTqdd0b, s_lb, dur),
        _qdd_des_k_indep(Tqd0b, TTqdd0b, s_ub, dur),
        qddie_s, qddie_v, s_lb, s_ub,
    )
    qdd_center = 0.5 * (qddi_hi + qddi_lo)
    qdd_ir = 0.5 * (qddi_hi - qddi_lo)

    B = q0.shape[0]
    bt = (B, T)
    cos_q, sin_q, qd_list, qda_list, qdda_list, R_list, Rt_list = [], [], [], [], [], [], []
    for i in range(nf):
        key = ((i, 1),)

        def col(x):
            return x[..., i].expand(bt)

        cos_q.append(PZ.from_gens(col(cos_center), [key], [col(cos_kcoeff)], r=col(cos_radius), nval=0))
        sin_q.append(PZ.from_gens(col(sin_center), [key], [col(sin_kcoeff)], r=col(sin_radius), nval=0))
        R_i = rot_from_cos_sin(cos_q[i], sin_q[i], int(spec.axes[i]), fixed[i])
        R_list.append(R_i)
        Rt_list.append(pz_transpose(R_i))
        qd_list.append(PZ.from_gens(col(qd_center), [key], [col(qd_kc)],
                                    r=col(qd_kr + qd_ir + qde), nval=0))
        qda_list.append(PZ.from_gens(col(qd_center), [key], [col(qd_kc)],
                                     r=col(qd_kr + qd_ir + qdae), nval=0))
        qdda_list.append(PZ.from_gens(col(qdd_center), [key], [col(qdd_kc)],
                                      r=col(qdd_kr + qdd_ir + qddae), nval=0))

    # fixed joints at the end of the chain (Trajectory.cu:247-251)
    for i in range(nf, spec.n_joints):
        Rf = PZ.const(const(fixed[i], dtype, dev).expand(bt + (3, 3)), nval=2)
        R_list.append(Rf)
        Rt_list.append(pz_transpose(Rf))

    # identity end-effector frame (Trajectory.cu:253: zero rpy rotation)
    R_list.append(PZ.const(torch.eye(3, dtype=dtype, device=dev).expand(bt + (3, 3)), nval=2))

    return BezierJRS(
        q0=q0, qd0=qd0, qdd0=qdd0, Tqd0=Tqd0, TTqdd0=TTqdd0, k_range=k_rng, duration=dur,
        cos_q=cos_q, sin_q=sin_q, qd_des=qd_list, qda_des=qda_list, qdda_des=qdda_list,
        R=R_list, R_t=Rt_list,
    )


# ---------------------------------------------------------------------------
# global joint position / velocity extrema for state-limit constraints
# (Trajectory.cu:256-540; gradients via torch.func in the NLP)
# ---------------------------------------------------------------------------

def joint_position_extrema(q0, Tqd0, TTqdd0, k_range, k):
    """(min_q, max_q) over the whole trajectory, differentiable in k.
    Elementwise over joints; every argument broadcasts."""
    ka = k_range * k
    disc = 64.0 * Tqd0**2 + 14.0 * Tqd0 * TTqdd0 - 120.0 * ka * Tqd0 + TTqdd0**2
    den = 5.0 * (6.0 * Tqd0 - 12.0 * ka + TTqdd0)
    den = torch.where(den.abs() < 1e-30, 1e-30, den)
    root = _safe_sqrt(disc)
    e2 = (2.0 * Tqd0 + TTqdd0 + root) / den
    e3 = (2.0 * Tqd0 + TTqdd0 - root) / den
    ok2 = (disc > 0.0) & (e2 >= 0.0) & (e2 <= 1.0)
    ok3 = (disc > 0.0) & (e3 >= 0.0) & (e3 <= 1.0)
    v1 = q_des_fn(q0, Tqd0, TTqdd0, ka, torch.zeros_like(ka))
    v4 = q_des_fn(q0, Tqd0, TTqdd0, ka, torch.ones_like(ka))
    v2 = q_des_fn(q0, Tqd0, TTqdd0, ka, _clip01(e2))
    v3 = q_des_fn(q0, Tqd0, TTqdd0, ka, _clip01(e3))
    big = 1e30
    mn = torch.minimum(
        torch.minimum(v1, v4),
        torch.minimum(torch.where(ok2, v2, big), torch.where(ok3, v3, big)),
    )
    mx = torch.maximum(
        torch.maximum(v1, v4),
        torch.maximum(torch.where(ok2, v2, -big), torch.where(ok3, v3, -big)),
    )
    return mn, mx


def joint_velocity_extrema(q0, Tqd0, TTqdd0, k_range, k, duration: float):
    """(min_qd, max_qd) in rad/s over the whole trajectory
    (Trajectory.cu:399-431)."""
    ka = k_range * k
    disc = 6.0 * (
        150.0 * ka**2
        - 180.0 * ka * Tqd0
        - 20.0 * ka * TTqdd0
        + 54.0 * Tqd0**2
        + 14.0 * Tqd0 * TTqdd0
        + TTqdd0**2
    )
    den = 10.0 * (6.0 * Tqd0 - 12.0 * ka + TTqdd0)
    den = torch.where(den.abs() < 1e-30, 1e-30, den)
    root = _safe_sqrt(disc)
    e2 = (18.0 * Tqd0 - 30.0 * ka + 4.0 * TTqdd0 + root) / den
    e3 = (18.0 * Tqd0 - 30.0 * ka + 4.0 * TTqdd0 - root) / den
    ok2 = (disc > 0.0) & (e2 >= 0.0) & (e2 <= 1.0)
    ok3 = (disc > 0.0) & (e3 >= 0.0) & (e3 <= 1.0)
    v1 = qd_des_fn(q0, Tqd0, TTqdd0, ka, torch.zeros_like(ka))
    v4 = qd_des_fn(q0, Tqd0, TTqdd0, ka, torch.ones_like(ka))
    v2 = qd_des_fn(q0, Tqd0, TTqdd0, ka, _clip01(e2))
    v3 = qd_des_fn(q0, Tqd0, TTqdd0, ka, _clip01(e3))
    big = 1e30
    mn = torch.minimum(
        torch.minimum(v1, v4),
        torch.minimum(torch.where(ok2, v2, big), torch.where(ok3, v3, big)),
    )
    mx = torch.maximum(
        torch.maximum(v1, v4),
        torch.maximum(torch.where(ok2, v2, -big), torch.where(ok3, v3, -big)),
    )
    return mn / duration, mx / duration
