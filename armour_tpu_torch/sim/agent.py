"""Plant simulation: fixed-step RK4 rollout with the low-level controller
in the loop, batched over worlds.

Port of `armour_tpu/sim/agent.py`, the rebuild of `uarmtd_agent.m`: true
dynamics qdd = M^-1 (u - C qd - g) with transmission inertia on the M
diagonal (`uarmtd_agent.m:385-424`), integrated with RK4 at a fixed
sub-millisecond step instead of ode15s (`uarmtd_agent.m:292-311`).

The JAX package runs the steps as one jitted ``lax.scan`` per world; here
every tensor carries the worlds in front (state (B, nf); any leading dims,
or none, work).  On a card ``rollout`` runs the whole move as ONE launch of
a hand-written kernel (`sim/rollout_kernel.py`, `csrc/rollout.cu`), the
counterpart of that scan; ``rollout_plain`` is the plain PyTorch version
(the CPU path and the kernel's reference), in which one step is captured as
a CUDA graph at the first step of each call on a card and replayed for the
others (`utils/graphs.py`).  The step's time, noise row and iLQR knot are read
from per-call device tables at a device step index that the step itself
advances, so nothing of the host is frozen into the graph.  Each step is
written for few device launches: the seven unit accelerations of the mass
matrix and the bias forces are ONE stacked RNEA pass with a leading axis of
8, the joint rotations are computed once per evaluation point, and the
link constants are made once per rollout.

Measurement noise comes from an explicit ``torch.Generator`` (or a given
``noise`` tensor); the JAX package draws it from ``jax.random``, so the two
differ for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from armour_tpu_torch.config import SimConfig
from armour_tpu_torch.control.ilqr import ilqr_control, tvlqr_gain_schedule
from armour_tpu_torch.control.robust import (
    althoff_control,
    nominal_passivity_control,
    pid_control,
    robust_control,
)
from armour_tpu_torch.device import const, resolve_device
from armour_tpu_torch.dynamics.rnea import joint_rotations, link_constants, rnea
from armour_tpu_torch.jrs.armtd import armtd_ref
from armour_tpu_torch.jrs.bezier import bezier_ref
from armour_tpu_torch.ops.linalg import spd_solve_small
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.utils.graphs import release, stepper

CONTROLLERS = ("robust", "althoff", "nominal", "pid", "ilqr")


class TrajParams(NamedTuple):
    """Active reference trajectory with a time offset, fields (..., nf) and
    ``t_offset`` (...,).

    For ``traj_type="bernstein"`` the fields parameterize a Bezier
    (q0, qd0, qdd0, k_actual); for ``traj_type="orig"`` (ARMTD comparison
    mode) they parameterize the constant-acceleration peak-and-brake
    trajectory of `..._comparison/Trajectory.h:18-60` (qdd0 is unused;
    k_actual is the acceleration k_a = g_k * k).  The braking fallback
    (`uarmtd_planner.m:883-933`) is "continue the previous trajectory
    shifted by t_move": offset += t_move.  Clamping local time to
    [0, duration] yields the exact terminal hold in BOTH parameterizations
    (qd = qdd = 0 at t = duration by construction)."""

    q0: torch.Tensor
    qd0: torch.Tensor
    qdd0: torch.Tensor
    k_actual: torch.Tensor
    t_offset: torch.Tensor


def traj_eval(p: TrajParams, t, duration: float = 1.0,
              traj_type: str = "bernstein", t_plan: float = 0.5):
    """Reference (q, qd, qdd) at local time t (offset applied, clamped);
    ``t`` is a number or a tensor that broadcasts against ``p.t_offset``.

    ``traj_type`` selects the realized trajectory family; the executed
    trajectory MUST match what the planner's reachable sets certified
    (`uarmtd_planner.m:858-937` switches `desired_trajectory` the same way).
    """
    tt = torch.clamp(t + p.t_offset, 0.0, duration)[..., None]
    if traj_type == "orig":
        return armtd_ref(p.q0, p.qd0, p.k_actual, tt, t_plan, duration)
    return bezier_ref(p.q0, p.qd0, p.qdd0, p.k_actual, tt, duration)


class TrueParams(NamedTuple):
    """The plant's true (unknown to the controller) inertial parameters as
    per-link scale factors (`uarmtd_agent` params.true)."""

    mass_scale: torch.Tensor     # (..., n_joints)
    inertia_scale: torch.Tensor  # (..., n_joints)


class RolloutLog(NamedTuple):
    t: torch.Tensor        # (S,)
    q: torch.Tensor        # (..., S, nf)
    qd: torch.Tensor
    q_ref: torch.Tensor
    qd_ref: torch.Tensor
    u: torch.Tensor


def _on(dev, dtype, *xs):
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in xs)


def rollout_direct(
    spec: RobotSpec,
    sim: SimConfig,
    q,
    qd,
    traj: TrajParams,
    true_params: TrueParams,
    duration: float = 1.0,
    traj_type: str = "bernstein",
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """'direct' move mode (`uarmtd_agent.m:493-507`): execute the reference
    trajectory exactly (no plant), logging nominal RNEA torques."""
    dev = resolve_device(device)
    traj = TrajParams(*_on(dev, dtype, *traj))
    n = int(round(sim.t_move / sim.check_dt))
    ts = torch.arange(n, dtype=dtype, device=dev) * sim.check_dt
    # a time axis in front of the joints: fields (..., 1, nf) against ts (S,)
    over_t = TrajParams(*(x.unsqueeze(-2) for x in traj[:4]), traj.t_offset.unsqueeze(-1))
    qs, qds, qdds = traj_eval(over_t, ts, duration, traj_type, sim.t_move)
    us = rnea(spec, qs, qds, qds, qdds, use_gravity=True, use_armature=True)
    q_end, qd_end, _ = traj_eval(traj, sim.t_move, duration, traj_type, sim.t_move)
    log = RolloutLog(t=ts, q=qs, qd=qds, q_ref=qs, qd_ref=qds, u=us)
    return q_end, qd_end, log


def rollout(
    spec: RobotSpec,
    sim: SimConfig,
    q,
    qd,
    traj: TrajParams,
    true_params: TrueParams,
    duration: float = 1.0,
    noise=None,
    generator: torch.Generator | None = None,
    controller: str = "robust",
    traj_type: str = "bernstein",
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """Integrate the closed loop over [0, t_move] for all worlds at once:
    on a card as ONE launch of the rollout kernel
    (`sim/rollout_kernel.py::fused_rollout`, `csrc/rollout.cu`), on the CPU
    by `rollout_plain`.  The arguments and results are `rollout_plain`'s,
    which is also the reference the kernel is held to."""
    if controller not in CONTROLLERS:
        raise ValueError(f"unknown controller {controller!r}")
    dev = resolve_device(device)
    kw = dict(duration=duration, noise=noise, generator=generator, controller=controller,
              traj_type=traj_type, device=dev, dtype=dtype)
    if dev.type == "cuda":
        from armour_tpu_torch.sim.rollout_kernel import fused_rollout

        return fused_rollout(spec, sim, q, qd, traj, true_params, **kw)
    return rollout_plain(spec, sim, q, qd, traj, true_params, **kw)


def rollout_plain(
    spec: RobotSpec,
    sim: SimConfig,
    q,
    qd,
    traj: TrajParams,
    true_params: TrueParams,
    duration: float = 1.0,
    noise=None,
    generator: torch.Generator | None = None,
    controller: str = "robust",
    traj_type: str = "bernstein",
    device=None,
    dtype: torch.dtype = torch.float64,
    eager: bool = False,
):
    """Integrate the closed loop over [0, t_move] for all worlds at once,
    in plain PyTorch: the CPU path of `rollout` and the reference its
    kernel is held to.

    ``noise`` (n_steps, 2, ..., nf), or ``generator`` with
    ``sim.measurement_noise_std > 0``, puts measurement noise on the state
    fed to the controller (`uarmtd_agent.m:314-325`).
    ``controller``: which low-level control law closes the loop: "robust"
    (ARMOUR CBF, the default), "althoff", "nominal"
    (`uarmtd_nominal_passivity_LLC.m`), "pid" (`robot_arm_PID_LLC.m`, the
    integral state threaded through the loop), or "ilqr"
    (`robot_arm_iLQR_LLC.m`, gains precomputed per rollout).
    ``traj_type``: trajectory family the plant tracks ("bernstein" Bezier
    or "orig" ARMTD peak-and-brake; t_plan = sim.t_move as in the
    reference where t_plan == t_move).
    ``eager``: on a card, run every step op by op instead of replaying the
    step's CUDA graph, to hold the two against each other.
    Returns (q_end, qd_end, log at check_dt resolution).
    """
    if controller not in CONTROLLERS:
        raise ValueError(f"unknown controller {controller!r}")
    dev = resolve_device(device)
    q, qd = _on(dev, dtype, q, qd)
    traj = TrajParams(*_on(dev, dtype, *traj))
    true_params = TrueParams(*_on(dev, dtype, *true_params))
    nf = spec.n_factors
    n_steps = int(round(sim.t_move / sim.plant_dt))
    log_every = max(1, int(round(sim.check_dt / sim.plant_dt)))
    dt = sim.plant_dt

    nominal = link_constants(spec, q)
    true = link_constants(
        spec, q, mass=nominal.mass * true_params.mass_scale,
        inertia=nominal.inertia * true_params.inertia_scale[..., None, None])

    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype, device=dev)
    elif generator is not None and sim.measurement_noise_std > 0.0:
        noise = sim.measurement_noise_std * torch.randn(
            (n_steps, 2) + q.shape, generator=generator, dtype=dtype, device=dev)

    def ref(t):
        return traj_eval(traj, t, duration, traj_type, sim.t_move)

    # per-step host values as device tables, read at the device step index
    step_i = torch.zeros(1, dtype=torch.long, device=dev)
    t_tab = const([i * dt for i in range(n_steps)], dtype, dev)
    if controller == "ilqr":
        # TVLQR backward pass once per rollout; gains looked up per step
        lqr_K, _ = tvlqr_gain_schedule(
            spec, ref, sim.t_move, sim.check_dt, device=dev, dtype=dtype)
        n_knots = lqr_K.shape[-3]
        # the step's time over the knot spacing as ONE product: exact where
        # the ratio is, while (i * dt) / check_dt can round under a knot
        # boundary (0.29 / 0.01 < 29); the JAX package's compiled rollout
        # folds the constants the same way
        knot_tab = const([min(int(i * (dt / sim.check_dt)), n_knots - 1)
                          for i in range(n_steps)], torch.long, dev)

    def control(q, qd, i_err, q_des, qd_des, qdd_des):
        if noise is None:
            qm, qdm = q, qd
        else:
            row = noise.index_select(0, step_i)[0]
            qm, qdm = q + row[0], qd + row[1]
        if controller == "robust":
            u, _, _ = robust_control(spec, qm, qdm, q_des, qd_des, qdd_des, consts=nominal)
        elif controller == "althoff":
            u, _, _ = althoff_control(spec, qm, qdm, q_des, qd_des, qdd_des, consts=nominal)
        elif controller == "nominal":
            u, _, _ = nominal_passivity_control(spec, qm, qdm, q_des, qd_des, qdd_des,
                                                consts=nominal)
        elif controller == "pid":
            u, _, _ = pid_control(spec, qm, qdm, q_des, qd_des, qdd_des, i_err, consts=nominal)
        else:
            gain = lqr_K.index_select(-3, knot_tab.index_select(0, step_i)).squeeze(-3)
            u, _, _ = ilqr_control(spec, qm, qdm, q_des, qd_des, qdd_des, gain, consts=nominal)
        return u, qm - q_des

    # the plant's M(q) columns (unit accelerations, no gravity) and bias
    # forces (qdd = 0, gravity) as ONE stacked RNEA pass with a leading axis
    # of nf + 1; the armature term vanishes on the bias row (qdd = 0) and the
    # damping term on the M rows (qd = 0), as in the separate passes
    ones = (1,) * (q.ndim - 1)
    unit_acc = torch.cat([torch.eye(nf, dtype=dtype, device=dev),
                          torch.zeros((1, nf), dtype=dtype, device=dev)]).reshape((nf + 1,) + ones + (nf,))
    bias_row = torch.cat([torch.zeros((nf,) + ones + (1,), dtype=dtype, device=dev),
                          torch.ones((1,) + ones + (1,), dtype=dtype, device=dev)])
    gravity_rows = bias_row[..., 0]

    def plant_acc(q, qd, u):
        qd_rows = bias_row * qd
        # the rotations written out over the stacked axis once, so that the
        # pass's products find equal batch dims and copy nothing
        R = joint_rotations(spec, q, true)
        R = R.expand((nf + 1,) + R.shape).contiguous()
        out = rnea(spec, q, qd_rows, qd_rows, unit_acc, use_gravity=gravity_rows,
                   use_armature=True, consts=true, R=R)
        M = out[:nf].movedim(0, -1)
        # M is SPD (mass matrix + transmission inertia on the diagonal)
        return spd_solve_small(M, u - out[nf])

    # the step's state, in buffers that every step updates in place (the
    # graph's inputs and outputs); `last` holds the last step's reference
    # and input for the log, in buffers made at the first step (a capture
    # computes nothing, so the log never reads a tensor the capture made)
    state_q, state_qd = q.clone(), qd.clone()
    i_err = torch.zeros_like(q)
    last = {}

    def step():
        q, qd = state_q, state_qd
        q_ref, qd_ref, qdd_ref = ref(t_tab.index_select(0, step_i).reshape(()))
        # zero-order hold within the step
        u, e_pos = control(q, qd, i_err, q_ref, qd_ref, qdd_ref)

        k1q, k1v = qd, plant_acc(q, qd, u)
        q2, v2 = q + 0.5 * dt * k1q, qd + 0.5 * dt * k1v
        k2q, k2v = v2, plant_acc(q2, v2, u)
        q3, v3 = q + 0.5 * dt * k2q, qd + 0.5 * dt * k2v
        k3q, k3v = v3, plant_acc(q3, v3, u)
        q4, v4 = q + dt * k3q, qd + dt * k3v
        k4q, k4v = v4, plant_acc(q4, v4, u)
        new_q = q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q)
        new_qd = qd + dt / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
        # i_err is the continuous-time integral of the position error
        # (dt-scaled), an intentional deviation from robot_arm_PID_LLC.m:90,
        # which sums raw per-step error; pid_control's K_i is tuned for the
        # dt-scaled form and is integrator-step-size independent
        i_err.copy_(i_err + dt * e_pos)
        state_q.copy_(new_q)
        state_qd.copy_(new_qd)
        step_i.add_(1)
        for name, x in (("q_ref", q_ref), ("qd_ref", qd_ref), ("u", u)):
            if name in last:
                last[name].copy_(x)
            else:
                last[name] = x.clone()

    advance = stepper(step, dev, eager)
    hist = []
    for i in range(n_steps):
        logged = i % log_every == 0    # check_dt resolution for the safety oracles
        if logged:
            q_i, qd_i = state_q.clone(), state_qd.clone()
        advance()
        if logged:
            hist.append((i * dt, q_i, qd_i, last["q_ref"].clone(), last["qd_ref"].clone(),
                         last["u"].clone()))
    release(advance)

    log = RolloutLog(
        t=const([h[0] for h in hist], dtype, dev),
        **{name: torch.stack([h[j] for h in hist], dim=-2)
           for j, name in enumerate(("q", "qd", "q_ref", "qd_ref", "u"), start=1)})
    return state_q, state_qd, log
