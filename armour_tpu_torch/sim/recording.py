"""Recorded episodes: a host-driven receding-horizon loop with full logging,
checkpointing, and replay.

Port of `armour_tpu/sim/recording.py`, the equivalent of the reference's
per-trial `.mat` dumps + `kinova_replay_trial.m`: each iteration's plan,
reference trajectory, plant log, and safety flags are kept and can be
saved to one ``.npz`` for replay, plotting or hardware export.

The batched harness (`sim/harness.py`) is the fast path; this module trades
throughput for observability (one episode at a time, logs on the host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.device import to_numpy
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.planner.hlp import clearance_waypoint, straight_line_waypoint
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.sim.agent import TrajParams, TrueParams, rollout, traj_eval
from armour_tpu_torch.sim.harness import Draws, generator_draws, random_true_params
from armour_tpu_torch.sim.world import World, arm_collision_check, goal_check


class IterationRecord(NamedTuple):
    k: np.ndarray
    feasible: bool
    q_des: np.ndarray          # waypoint
    t: np.ndarray              # (S,) within-iteration times
    q: np.ndarray              # (S, nf)
    qd: np.ndarray
    q_ref: np.ndarray
    qd_ref: np.ndarray
    u: np.ndarray
    torque_radius: np.ndarray  # (T, nf)
    q0p: np.ndarray            # planning state (reference state at t_move)
    qd0p: np.ndarray
    qdd0p: np.ndarray


@dataclasses.dataclass
class EpisodeRecording:
    world: World
    records: list
    goal_reached: bool
    collision: bool
    stopped: bool

    def save(self, path):
        n = len(self.records)

        def stack(field, empty):
            return np.stack([getattr(r, field) for r in self.records]) if n else empty

        def cat(field):
            return np.concatenate([getattr(r, field) for r in self.records]) if n else np.zeros((0, 7))

        np.savez_compressed(
            path,
            start=to_numpy(self.world.start),
            goal=to_numpy(self.world.goal),
            obstacles=to_numpy(self.world.obstacles.zonos),
            obstacle_mask=to_numpy(self.world.obstacles.mask),
            goal_reached=self.goal_reached,
            collision=self.collision,
            stopped=self.stopped,
            k=stack("k", np.zeros((0, 7))),
            feasible=np.asarray([r.feasible for r in self.records]),
            q=cat("q"), qd=cat("qd"), q_ref=cat("q_ref"), qd_ref=cat("qd_ref"), u=cat("u"),
            t=np.concatenate([r.t + i * 0.5 for i, r in enumerate(self.records)])
            if n else np.zeros(0),
            torque_radius=stack("torque_radius", np.zeros((0, 0, 7))),
            q0p=stack("q0p", np.zeros((0, 7))),
            qd0p=stack("qd0p", np.zeros((0, 7))),
            qdd0p=stack("qdd0p", np.zeros((0, 7))),
        )

    def export_hardware_csv(self, path, dt: float = 0.01):
        """Reference/actual trajectory CSV for hardware playback
        (`sim_to_csv.m` equivalent): columns t, q_ref x7, qd_ref x7, q x7."""
        rows = []
        for i, r in enumerate(self.records):
            for j in range(r.t.shape[0]):
                rows.append(
                    np.concatenate(
                        [[r.t[j] + i * 0.5], r.q_ref[j], r.qd_ref[j], r.q[j]]
                    )
                )
        np.savetxt(path, np.asarray(rows), delimiter=",", fmt="%.6g")


def run_recorded_episode(
    spec: RobotSpec,
    pcfg: PlannerConfig,
    scfg: SimConfig,
    world: World,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float64,
    planner: ArmourPlanner | None = None,
    verbose: bool = False,
    device=None,
    true_params: TrueParams | None = None,
    draws: Callable[[int], Draws] | None = None,
) -> EpisodeRecording:
    """One episode, every iteration logged on the host.

    ``generator`` (on the planner's device, seeded 0 when None) lives for
    the whole episode and makes every draw not given: ``true_params``
    (n_joints,) fields and the per-iteration ``draws`` (batch of one; the
    clearance samples are used only on a stalled replan)."""
    planner = planner or ArmourPlanner(spec, pcfg, dtype, device)
    dev, dtype = planner.device, planner.dtype
    nf = spec.n_factors

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    if true_params is None:
        true_params = TrueParams(*(x[0] for x in random_true_params(scfg, 1, spec.n_joints,
                                                                     gen, dtype)))
    tp = TrueParams(t(true_params.mass_scale), t(true_params.inertia_scale))
    draws = draws if draws is not None else generator_draws(planner, scfg, 1, gen)

    start, goal = t(world.start), t(world.goal)
    obstacles = world.obstacles._replace(zonos=t(world.obstacles.zonos),
                                         mask=torch.as_tensor(world.obstacles.mask, device=dev))
    q = start
    qd = torch.zeros(nf, dtype=dtype, device=dev)
    traj = TrajParams(q0=q, qd0=qd, qdd0=torch.zeros(nf, dtype=dtype, device=dev),
                      k_actual=torch.zeros(nf, dtype=dtype, device=dev),
                      t_offset=t(pcfg.duration))

    records = []
    goal_reached = collision = stopped = False
    fails = 0
    stall = 0
    best_dist = np.inf
    k_prev = torch.zeros(nf, dtype=dtype, device=dev)
    goal_np = to_numpy(goal).astype(float)
    cont_np = np.asarray(spec.continuous_joints)
    for it in range(scfg.max_iterations):
        d = draws(it)
        q0p, qd0p, qdd0p = traj_eval(traj, scfg.t_move, pcfg.duration)
        q_des = straight_line_waypoint(spec, q, goal)
        if stall >= scfg.stall_clearance:
            # the battery drivers' first-stage escalation: sampled clearance
            # waypoints instead of re-driving the local minimum
            q_des = clearance_waypoint(spec, q, goal, obstacles, noise=d.clearance_noise[0])
        plan = planner.plan(q0p, qd0p, qdd0p, q_des, obstacles, k_rand=d.k_rand[0],
                            k_warm=k_prev)
        feasible = bool(plan.feasible)
        if feasible:
            traj = TrajParams(q0=q0p, qd0=qd0p, qdd0=qdd0p,
                              k_actual=t(pcfg.k_range) * torch.nan_to_num(plan.k),
                              t_offset=t(0.0))
            fails = 0
        else:
            traj = traj._replace(t_offset=traj.t_offset + scfg.t_move)
            fails += 1

        k_prev = torch.nan_to_num(plan.k)
        q, qd, log = rollout(spec, scfg, q, qd, traj, tp, pcfg.duration, device=dev, dtype=dtype)
        records.append(
            IterationRecord(
                k=to_numpy(plan.k), feasible=feasible, q_des=to_numpy(q_des),
                t=to_numpy(log.t), q=to_numpy(log.q), qd=to_numpy(log.qd),
                q_ref=to_numpy(log.q_ref), qd_ref=to_numpy(log.qd_ref),
                u=to_numpy(log.u), torque_radius=to_numpy(plan.torque_radius),
                q0p=to_numpy(q0p), qd0p=to_numpy(qd0p), qdd0p=to_numpy(qdd0p),
            )
        )
        if verbose:
            print(f"iter {it}: feasible={feasible}")

        if bool(arm_collision_check(spec, log.q, obstacles).any()):
            collision = True
            break
        if bool(goal_check(spec, q, goal, scfg.goal_radius)):
            goal_reached = True
            break
        if fails >= scfg.stop_threshold:
            stopped = True
            break
        d_goal = to_numpy(q).astype(float) - goal_np
        d_goal = np.where(cont_np, (d_goal + np.pi) % (2 * np.pi) - np.pi, d_goal)
        dist = float(np.linalg.norm(d_goal))
        stall = 0 if dist < best_dist - scfg.progress_epsilon else stall + 1
        best_dist = min(best_dist, dist)

    return EpisodeRecording(
        world=world, records=records, goal_reached=goal_reached,
        collision=collision, stopped=stopped,
    )


def load_recording(path) -> dict:
    """Load a saved episode for replay/plotting (`kinova_replay_trial.m`)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
