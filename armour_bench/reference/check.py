"""The plain reference of a plan, and the comparison that decides `correct`.

The reference works every plan out again from the inputs the traffic
generator handed to the program (start state, goal, obstacles), in float64
and with the geometry as stated: exact hyperplane normals and no numeric
slack.  It builds the reachable sets (the Bezier JRS and the polynomial-
zonotope forward kinematics and RNEA of the frozen copies beside this
file) and the obstacle bank, and evaluates at three points per world:

- the program's answer ``k`` (where the answer is feasible);
- ``k = 0``, which the program's pool of candidates always holds;
- the box-clipped minimiser of the cost alone, ``k_unc`` (the cost is a
  sum of per-joint squares of an affine function of k, so it has a closed
  form).

It reads the program's answers only to judge them.  The numbers compared,
each with the limit of the cell's file:

- ``t_rad_gap``: the build.  The worst gap between the program's torque
  radius (``PlanResult.torque_radius``, a product of the JRS and the
  PZ-RNEA) and the reference's, against the reference's largest entry of
  that world.
- ``cost_gap``: the solve's answer.  For each feasible answer, the gap
  between the cost it reports and the reference's cost at its ``k``.  Cost
  in rad^2, as ``PlanResult.cost`` (unscaled).
- ``opt_gap``: that the solve moved.  Over the feasible answers of worlds
  whose ``k_unc`` the reference finds feasible with room (``MARGINS``), the
  median gap between the reported cost and the cost at ``k_unc``: a solve
  that moved reaches ``k_unc`` in nearly every such world (its Gauss-Newton
  step on this separable quadratic lands on it), one that did not stays at
  a start.  A median, since a local solve may end against an obstacle that
  lies between its starts and ``k_unc`` (found at 40 obstacles, where the
  float64 solve on the CPU ends at the same ``k``).
- ``unsafe``: the verification and the bank pass.  Answers marked
  feasible whose ``k`` the reference finds in violation of a threshold of
  the configuration (collision, torque or joint limits).  Exact: 0.
- ``missed``: answers marked infeasible for a world whose ``k = 0`` the
  reference finds feasible with room.  Exact: 0.
- ``viol_gap``: the constraint values at the answer, and with them the
  bank pass.  For each feasible answer, the gap between the worst
  constraint value the program reports there (``PlanResult.max_violation``,
  the largest of its torque, collision and state values) and the
  reference's largest at the same ``k``, with the configuration's numeric
  slacks added as the program adds them; in the units of the block that
  is worst (m, N m or rad).  The configuration's bfloat16 normals set the
  sound gap.  Culling (``obstacle_culling``) drops from the program's bank
  the obstacles whose boxes lie more than 1.01e-3 m clear of every link's
  reachable box, whose values therefore lie below -1.01e-3; where a cell's
  traffic culls, its ``viol_above`` keeps the comparison to the answers
  whose largest value lies above that.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from armour_bench.reference.bezier import (
    joint_position_extrema,
    joint_velocity_extrema,
    make_bezier_jrs,
    q_des_fn,
)
from armour_bench.reference.config import PlannerConfig
from armour_bench.reference.pz import PackedPZ, pack_pzs
from armour_bench.reference.pz_rnea import build_reachable_sets
from armour_bench.reference.spec import RobotSpec
from armour_bench.reference.zonotope import ObstacleSet, buffer_obstacles, collision_values

# Room by which the reference must find a point feasible before the program
# is held to finding it too: above the program's own conservatism, which is
# its slack (1e-5 m, 1e-3 N m), its bfloat16 normals (up to ~4e-3 of the
# distance to the support point, ~1e-3 m) and float32 rounding.
MARGINS = {"collision": 5e-3, "torque": 5e-3, "state": 1e-4}

# bytes of float64 pieces a block of worlds may hold at once
_BLOCK_BYTES = 3 << 30


class Reference(NamedTuple):
    """The reference's build of B worlds (float64)."""

    links: PackedPZ          # link centers (B, T, L, 3) over k
    u: PackedPZ              # nominal torques (B, T, nf) over k
    t_rad: torch.Tensor      # (B, T, nf), the configuration's torque slack included
    hp: object               # exact hyperplane bank, no slack
    q0: torch.Tensor         # (B, nf)
    Tqd0: torch.Tensor
    TTqdd0: torch.Tensor
    k_range: torch.Tensor    # (nf,)
    q_des: torch.Tensor      # (B, nf)


def wrap_to_pi(x):
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def build(spec: RobotSpec, cfg: PlannerConfig, q0, qd0, qdd0, q_des, zonos, masks) -> Reference:
    """Reachable sets, torque radius and exact bank of B worlds; every
    argument a float64 tensor (masks bool) on one device."""
    jrs = make_bezier_jrs(spec, cfg, q0, qd0, qdd0)
    rs = build_reachable_sets(spec, cfg, jrs)
    hp = buffer_obstacles(rs.link_indep_gens, ObstacleSet(zonos, masks), slack=0.0,
                          store_bf16=False)
    return Reference(pack_pzs(rs.link_pz, axis=2), pack_pzs(rs.u_nom, axis=-1),
                     rs.torque_radius, hp, q0, jrs.Tqd0, jrs.TTqdd0, jrs.k_range, q_des)


def _t(spec_array, like):
    return torch.as_tensor(np.asarray(spec_array), dtype=like.dtype, device=like.device)


def blocks(spec: RobotSpec, cfg: PlannerConfig, ref: Reference, K) -> dict:
    """The worst constraint value of each block at K (B, S, nf): {name:
    (B, S)}, feasible iff each is at most the configuration's threshold."""
    t_lim = _t(spec.torque_limits, K)
    t_rad = (ref.t_rad - cfg.torque_numeric_slack)[:, None]      # the radius as stated
    u_c, _, _ = ref.u.slice_with_jac_multi(K)                       # (B, S, T, nf)
    torque = torch.maximum(u_c - (t_lim - t_rad), (-t_lim + t_rad) - u_c).flatten(2).amax(-1)
    centers, _, _ = ref.links.slice_with_jac_multi(K)               # (B, S, T, L, 3)
    collision = collision_values(ref.hp, centers).flatten(2).amax(-1)
    qe, qde = spec.qe, spec.qde
    pos_lb, pos_ub = _t(spec.pos_limits_lb + qe, K), _t(spec.pos_limits_ub - qe, K)
    vel_lb, vel_ub = _t(-spec.speed_limits + qde, K), _t(spec.speed_limits - qde, K)
    q0b, Tqd0b, TTqdd0b = ref.q0[:, None], ref.Tqd0[:, None], ref.TTqdd0[:, None]
    mn, mx = joint_position_extrema(q0b, Tqd0b, TTqdd0b, ref.k_range, K)
    vn, vx = joint_velocity_extrema(q0b, Tqd0b, TTqdd0b, ref.k_range, K, cfg.duration)
    state = torch.cat([pos_lb - mn, mn - pos_ub, pos_lb - mx, mx - pos_ub,
                       vel_lb - vn, vn - vel_ub, vel_lb - vx, vx - vel_ub], dim=-1).amax(-1)
    return {"collision": collision, "torque": torque, "state": state}


def thresholds(cfg: PlannerConfig) -> dict:
    return {"collision": cfg.collision_violation_threshold,
            "torque": cfg.torque_violation_threshold,
            "state": cfg.state_violation_threshold}


def programmed(cfg: PlannerConfig, vals: dict):
    """(3, B, S): the worst collision, torque and state values as the
    program forms them, the blocks as stated plus the configuration's
    numeric slacks (each obstacle's half-width inflated by the collision
    slack, the torque radius by the torque slack); their largest compares
    with ``max_violation``."""
    return torch.stack([vals["collision"] + cfg.collision_numeric_slack,
                        vals["torque"] + cfg.torque_numeric_slack, vals["state"]])


def cost(spec: RobotSpec, cfg: PlannerConfig, ref: Reference, K):
    """The plan's cost at K (B, S, nf), unscaled: sum over joints of the
    squared (wrapped, for continuous joints) distance of q(t_plan) to the
    goal."""
    q_plan = q_des_fn(ref.q0[:, None], ref.Tqd0[:, None], ref.TTqdd0[:, None],
                      ref.k_range * K, cfg.t_plan / cfg.duration)
    d = q_plan - ref.q_des[:, None]
    cont = torch.as_tensor(spec.continuous_joints, device=K.device)
    d = torch.where(cont, wrap_to_pi(d), d)
    return torch.sum(d * d, dim=-1)


def k_unconstrained(spec: RobotSpec, cfg: PlannerConfig, ref: Reference):
    """(B, nf): the minimiser of the cost alone over the box [-1, 1]^nf.
    q(t_plan) is affine in k per joint, q = a + b k."""
    s = cfg.t_plan / cfg.duration
    zero = torch.zeros_like(ref.q0)
    a = q_des_fn(ref.q0, ref.Tqd0, ref.TTqdd0, ref.k_range * zero, s)
    b = q_des_fn(ref.q0, ref.Tqd0, ref.TTqdd0, ref.k_range * (zero + 1.0), s) - a
    d = ref.q_des - a
    cont = torch.as_tensor(spec.continuous_joints, device=d.device)
    d = torch.where(cont, wrap_to_pi(d), d)
    return torch.clamp(d / b, -1.0, 1.0)


def _block_size(n_live: int, T: int, L: int) -> int:
    per_world = 3 * 36 * L * max(n_live, 1) * T * 8 * 6
    return max(1, min(64, _BLOCK_BYTES // per_world))


def judge(spec: RobotSpec, cfg: PlannerConfig, inputs: dict, answers: dict, device,
          viol_above: float | None = None) -> dict:
    """The numbers compared, over N worlds.  ``inputs``: q0, qd0, qdd0, q_des
    (N, nf), zonos (N, cap, 4, 3), masks (N, cap), as the generator made
    them; ``answers``: k (N, nf), feasible (N,), cost (N,), max_violation
    (N,), t_rad (N, T, nf), as the program returned them.  Numpy arrays or
    tensors.  ``viol_above``: where given, ``viol_gap`` compares only the
    answers whose largest constraint value the reference finds above it."""
    f64 = dict(dtype=torch.float64, device=device)
    inp = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
           for k, v in inputs.items()}
    ans = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
           for k, v in answers.items()}
    N = inp["q0"].shape[0]
    live_any = inp["masks"].bool().any(0)
    n_live = int(torch.nonzero(live_any).max()) + 1 if bool(live_any.any()) else 1
    thr = thresholds(cfg)
    step = _block_size(n_live, cfg.num_time_steps, spec.n_joints)
    t_rad_gap = cost_gap = viol_gap = 0.0
    unsafe = missed = n_unc = n_zero = n_viol = 0
    worst_block = {b: 0 for b in ("collision", "torque", "state")}
    short = []
    worst = {"t_rad_world": -1, "cost_world": -1, "viol_world": -1}
    for lo in range(0, N, step):
        sl = slice(lo, min(N, lo + step))
        ref = build(spec, cfg, *(inp[k][sl].to(**f64) for k in ("q0", "qd0", "qdd0", "q_des")),
                    inp["zonos"][sl, :n_live].to(**f64), inp["masks"][sl, :n_live].bool())
        # the build: the torque radius
        t_port = ans["t_rad"][sl].to(**f64)
        gap = (t_port - ref.t_rad).abs().flatten(1).amax(1) / ref.t_rad.abs().flatten(1).amax(1)
        gap = torch.where(torch.isnan(gap), torch.inf, gap)
        if float(gap.max()) > t_rad_gap:
            t_rad_gap, worst["t_rad_world"] = float(gap.max()), lo + int(gap.argmax())
        # the solve and the verification, at the answer, k = 0 and k_unc
        feas = ans["feasible"][sl].bool()
        k_ans = torch.where(feas[:, None], ans["k"][sl].to(**f64), 0.0)
        k_unc = k_unconstrained(spec, cfg, ref)
        K = torch.stack([k_ans, torch.zeros_like(k_ans), k_unc], dim=1)
        vals = blocks(spec, cfg, ref, K)
        over = torch.stack([vals[b] > thr[b] for b in thr]).any(0)                  # (Bw, 3)
        clear = torch.stack([vals[b] <= thr[b] - MARGINS[b] for b in thr]).all(0)   # (Bw, 3)
        c_ref = cost(spec, cfg, ref, K)
        c_port = ans["cost"][sl].to(**f64)
        unsafe += int((feas & over[:, 0]).sum())
        missed += int((~feas & clear[:, 1]).sum())
        n_zero += int(clear[:, 1].sum())
        n_unc += int((feas & clear[:, 2]).sum())
        gaps = torch.where(feas, (c_port - c_ref[:, 0]).abs(), 0.0)
        gaps = torch.where(feas & torch.isnan(gaps), torch.inf, gaps)
        opt = (c_port - c_ref[:, 2]).abs()
        short.append(torch.where(torch.isnan(opt), torch.inf, opt)[feas & clear[:, 2]].cpu())
        if float(gaps.max()) > cost_gap:
            cost_gap, worst["cost_world"] = float(gaps.max()), lo + int(gaps.argmax())
        # the constraint values at the answer
        per_block = programmed(cfg, vals)[:, :, 0]                                  # (3, Bw)
        v_ref = per_block.amax(0)
        judged = feas if viol_above is None else feas & (v_ref > viol_above)
        n_viol += int(judged.sum())
        v_gap = torch.where(judged, (ans["max_violation"][sl].to(**f64) - v_ref).abs(), 0.0)
        v_gap = torch.where(judged & torch.isnan(v_gap), torch.inf, v_gap)
        if float(v_gap.max()) > viol_gap:
            viol_gap, worst["viol_world"] = float(v_gap.max()), lo + int(v_gap.argmax())
        which = per_block.argmax(0)
        for i, b in enumerate(("collision", "torque", "state")):
            worst_block[b] += int((feas & (which == i)).sum())
        del ref, vals
    short = torch.cat(short)
    opt_gap = float(short.median()) if short.numel() else 0.0
    return {"t_rad_gap": t_rad_gap, "cost_gap": cost_gap, "opt_gap": opt_gap, "viol_gap": viol_gap,
            "unsafe": unsafe,
            "missed": missed, "checked": N, "feasible": int(ans["feasible"].bool().sum()),
            "k_unc_clear": n_unc, "k0_clear": n_zero, "viol_judged": n_viol,
            "opt_max": float(short.max()) if short.numel() else 0.0,
            **{f"worst_{b}": n for b, n in worst_block.items()}, **worst}
