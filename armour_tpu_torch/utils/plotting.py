"""Figure factory for recorded episodes (a compact rebuild of the
reference's `post_sim_plotting.m`).

Port of `armour_tpu/utils/plotting.py`.  Every function takes the dict
returned by `sim.recording.load_recording` (or an ``EpisodeRecording.save``
file) and writes PNGs with matplotlib's Agg backend (headless).  Without
matplotlib each figure function returns ``None`` and draws nothing.

The numbers two figures draw come from plain functions that need no
matplotlib: ``constraint_traces`` (the per-iteration constraint traces, all
selected iterations rebuilt as ONE batch on the device) and
``grasp_wrench`` (the carried object's contact wrench).  The reachable-set
figures rebuild their iterations as one batch too (``sliced_frs``).
Functions that compute run on ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import collision_values_multi
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.device import resolve_device, to_numpy
from armour_tpu_torch.dynamics.pz_rnea import build_reachable_sets
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.dynamics.utility import ee_pose
from armour_tpu_torch.jrs.bezier import make_bezier_jrs
from armour_tpu_torch.ops.pz import pack_pzs
from armour_tpu_torch.planner.armour import ArmourPlanner

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except ImportError:
    HAVE_MPL = False


def _save(fig, out_path):
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _draw_obstacles(ax, rec, alpha):
    """The live obstacles of the recording as filled (x, y) boxes."""
    zon, mask = rec["obstacles"], rec["obstacle_mask"]
    for i in np.nonzero(mask)[0]:
        c = zon[i, 0]
        h = np.abs(zon[i, 1:]).sum(axis=0)
        ax.add_patch(plt.Rectangle((c[0] - h[0], c[1] - h[1]), 2 * h[0], 2 * h[1],
                                   fill=True, alpha=alpha, color="tab:red"))


def _ee_path(spec, q, dtype, device):
    """(N, 3) world positions of the last joint frame along ``q`` (N, nf)."""
    _, pw = forward_kinematics(spec, torch.as_tensor(q, dtype=dtype, device=device))
    return to_numpy(pw)[:, -1]


def sliced_frs(rec: dict, spec, iterations, cfg=None, dtype=torch.float64, device=None):
    """Rebuild the link reachable sets at the recorded planning states of
    ``iterations`` (one batched build) and slice them at the recorded k:
    (centres (I, T, L, 3), half widths of the link-shape generators
    (I, T, L, 3)) as host arrays.  The torque sets are not needed here and
    are not built."""
    device = resolve_device(device)
    cfg = dataclasses.replace(cfg or PlannerConfig(), input_constraints=False)
    it = np.asarray(iterations, dtype=int)

    def t(name):
        return torch.as_tensor(np.asarray(rec[name])[it], dtype=dtype, device=device)

    rs = build_reachable_sets(spec, cfg, make_bezier_jrs(spec, cfg, t("q0p"), t("qd0p"),
                                                         t("qdd0p")))
    k = torch.as_tensor(np.nan_to_num(np.asarray(rec["k"])[it]), dtype=dtype, device=device)
    centers, _, _ = pack_pzs(rs.link_pz, axis=2).slice_with_jac_multi(k[:, None])
    return to_numpy(centers[:, 0]), to_numpy(rs.link_indep_gens.abs().sum(-1))


class ConstraintTraces(NamedTuple):
    col_max: np.ndarray        # (I,) max collision constraint value at the recorded k
    tor_util: np.ndarray       # (I,) worst |u_nom| - (limit - planned radius); NaN without torque sets
    feasible: np.ndarray       # (I,) the recorded verdicts
    torque_radius: np.ndarray  # (I, T, nf) the rebuilt planned radii


def constraint_traces(rec: dict, spec, cfg=None, dtype=torch.float64,
                      device=None) -> ConstraintTraces:
    """For every recorded replan, rebuild the problem at the recorded
    planning state over the recorded obstacles (the pre-culling build: every
    slot of the recording, as the JAX figure's single-world build) and
    slice it at the recorded k.  All iterations are one batch, so the
    collision values are one launch of the values-only kernel on the card
    (S = 1, the obstacle bucket of the recording's live slots)."""
    cfg = cfg or PlannerConfig()
    planner = ArmourPlanner(spec, cfg, dtype, device=device)
    n_it = rec["k"].shape[0]
    zonos = np.repeat(rec["obstacles"][None], n_it, axis=0)
    masks = np.repeat(rec["obstacle_mask"][None], n_it, axis=0)
    prob = planner.build_probs(rec["q0p"], rec["qd0p"], rec["qdd0p"], zonos, masks, cull=False)
    k = torch.as_tensor(np.nan_to_num(rec["k"]), dtype=dtype, device=planner.device)[:, None]
    centers, _, _ = prob.links.slice_with_jac_multi(k)                  # k: (I, 1, n)
    col_max = to_numpy(collision_values_multi(prob.hp, centers).flatten(1).amax(1))
    if prob.u is not None:
        u_c, _, _ = prob.u.slice_with_jac_multi(k)                      # (I, 1, T, nf)
        t_lim = torch.as_tensor(spec.torque_limits, dtype=dtype, device=planner.device)
        util = u_c[:, 0].abs() - (t_lim - prob.t_rad)
        tor_util = to_numpy(util.flatten(1).amax(1))
    else:
        tor_util = np.full(n_it, np.nan)
    return ConstraintTraces(col_max, tor_util, np.asarray(rec["feasible"], bool)[:n_it],
                            to_numpy(prob.t_rad))


def grasp_wrench(spec, grasp, q_fn, duration: float = 1.0, n_samples: int = 200, device=None):
    """The carried object's contact wrench along ``q_fn(t) -> q`` (the
    realized joint trajectory), in the end-effector (tray) frame, from
    rigid-body Newton-Euler with finite-differenced end-effector
    kinematics:

        F = m (a_com - g),   N = I w_dot + w x I w + c x F

    Returns (ts, Fz, fric, zmp): the separation force (must stay > 0), the
    friction-cone ratio |F_xy| / (u_s Fz) (must stay < 1) and the ZMP point
    (-Ny/Fz, Nx/Fz) (must stay inside the contact circle of radius
    ``surf_rad``).  One batched ``ee_pose`` over the samples, in the dtype
    ``q_fn`` returns, on ``device``."""
    device = resolve_device(device)
    ts = np.linspace(0.0, duration, n_samples)
    dt = ts[1] - ts[0]
    qs = torch.stack([torch.as_tensor(q_fn(t)) for t in ts]).to(device)
    R, p = ee_pose(spec, qs)
    Rs = to_numpy(R).astype(float)               # (S, 3, 3) EE->world
    ps = to_numpy(p).astype(float)               # (S, 3) EE origin, world
    c_obj = np.asarray(grasp.object_com, float)
    p_com = ps + np.einsum("sij,j->si", Rs, c_obj)
    # linear acceleration of the object's COM (world frame)
    a_com = np.gradient(np.gradient(p_com, dt, axis=0), dt, axis=0)
    # angular velocity/acceleration from R_dot R^T (world), then EE frame
    Rdot = np.gradient(Rs, dt, axis=0)
    Wx = np.einsum("sij,skj->sik", Rdot, Rs)      # skew(omega_world)
    w_world = np.stack([Wx[:, 2, 1], Wx[:, 0, 2], Wx[:, 1, 0]], axis=1)
    wd_world = np.gradient(w_world, dt, axis=0)
    g = np.array([0.0, 0.0, -9.81])
    F_world = float(grasp.object_mass) * (a_com - g)
    F = np.einsum("sji,sj->si", Rs, F_world)      # EE frame
    w = np.einsum("sji,sj->si", Rs, w_world)
    wd = np.einsum("sji,sj->si", Rs, wd_world)
    I_o = np.diag(np.asarray(grasp.object_inertia_diag, float))
    N = (wd @ I_o.T) + np.cross(w, w @ I_o.T) + np.cross(c_obj[None], F)
    Fz = F[:, 2]
    fric = np.sqrt(F[:, 0] ** 2 + F[:, 1] ** 2) / np.maximum(grasp.u_s * Fz, 1e-9)
    zmp = np.stack([-N[:, 1], N[:, 0]], axis=1) / np.maximum(Fz[:, None], 1e-9)
    return ts, Fz, fric, zmp


def plot_tracking(rec: dict, spec, out_path):
    """Joint positions/velocities vs reference with ultimate-bound bands."""
    if not HAVE_MPL:
        return None
    t = rec["t"]
    fig, axes = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    for j in range(rec["q"].shape[1]):
        axes[0].plot(t, rec["q"][:, j] - rec["q_ref"][:, j], lw=0.8, label=f"j{j}")
        axes[1].plot(t, rec["qd"][:, j] - rec["qd_ref"][:, j], lw=0.8)
    for ax, bound in ((axes[0], spec.qe), (axes[1], 2 * spec.ultimate_bound)):
        ax.axhline(bound, color="r", ls="--", lw=1)
        ax.axhline(-bound, color="r", ls="--", lw=1)
    axes[0].set_ylabel("position error (rad)")
    axes[1].set_ylabel("velocity error (rad/s)")
    axes[1].set_xlabel("time (s)")
    axes[0].legend(ncol=4, fontsize=8)
    axes[0].set_title("tracking error vs ultimate bound")
    return _save(fig, out_path)


def plot_torques(rec: dict, spec, out_path):
    """Applied torques vs limits, with the PLANNED control-input-radius
    margin overlaid when the recording carries it (post_sim_plotting.m's
    input-vs-radius figure): the planner certifies |u_nominal| <=
    limit - radius(t), so the tightened-limit staircase shows the margin
    reserved for the robust term + model uncertainty."""
    if not HAVE_MPL:
        return None
    t = rec["t"]
    nf = rec["u"].shape[1]
    fig, axes = plt.subplots(nf, 1, figsize=(10, 1.6 * nf), sharex=True)
    t_rad = rec.get("torque_radius")
    for j in range(nf):
        axes[j].plot(t, rec["u"][:, j], lw=0.8)
        axes[j].axhline(spec.torque_limits[j], color="r", ls="--", lw=1)
        axes[j].axhline(-spec.torque_limits[j], color="r", ls="--", lw=1)
        if t_rad is not None and t_rad.size:
            # (n_iter, T, nf) planned radii; each iteration executes the
            # first half of its T-step horizon over t_move seconds
            n_it, T = t_rad.shape[:2]
            tt = (np.arange(n_it)[:, None] * 0.5
                  + np.linspace(0.0, 0.5, T // 2, endpoint=False)[None, :])
            tight = spec.torque_limits[j] - t_rad[:, : T // 2, j]
            axes[j].step(tt.ravel(), tight.ravel(), where="post", lw=0.7, color="tab:orange")
            axes[j].step(tt.ravel(), -tight.ravel(), where="post", lw=0.7, color="tab:orange")
        axes[j].set_ylabel(f"u{j} (Nm)", fontsize=8)
    axes[-1].set_xlabel("time (s)")
    axes[0].set_title("control inputs vs torque limits (orange: limit - planned radius)")
    return _save(fig, out_path)


def _draw_frs_topdown(rec, out_path, iteration, centers, half, ee):
    """One sliced forward-occupancy snapshot: per-(time, link) boxes of
    ``centers``/``half`` (T, L, 3) over the obstacles and the EE path."""
    fig, ax = plt.subplots(figsize=(8, 8))
    _draw_obstacles(ax, rec, 0.4)
    T = centers.shape[0]
    for t in range(0, T, max(1, T // 16)):
        for L in range(centers.shape[1]):
            c, h = centers[t, L], half[t, L]
            ax.add_patch(plt.Rectangle((c[0] - h[0], c[1] - h[1]), 2 * h[0], 2 * h[1],
                                       fill=False, lw=0.4, alpha=0.25 + 0.6 * t / T,
                                       color="tab:green"))
    ax.plot(ee[:, 0], ee[:, 1], "k-", lw=0.9, label="executed EE path")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend()
    ax.set_title(f"sliced forward-occupancy FRS over obstacles (iteration {iteration})")
    return _save(fig, out_path)


def plot_frs_topdown(rec: dict, spec, out_path, iteration: int = 0, cfg=None,
                     dtype=torch.float64, device=None):
    """FRS snapshot over obstacles (the reference's reachable-set figure):
    rebuild the reachable sets at the recorded planning state of one
    iteration, slice at the recorded k, and draw the per-(time, link)
    forward-occupancy boxes over the obstacles and the executed EE path."""
    if not HAVE_MPL:
        return None
    if "q0p" not in rec or rec["k"].shape[0] <= iteration:
        return None
    device = resolve_device(device)
    centers, half = sliced_frs(rec, spec, [iteration], cfg, dtype, device)
    return _draw_frs_topdown(rec, out_path, iteration, centers[0], half[0],
                             _ee_path(spec, rec["q"], dtype, device))


def plot_world_topdown(rec: dict, spec, out_path, n_snapshots: int = 8, device=None):
    """Top-down (x, y) world view: obstacles + end-effector path + arm
    snapshot skeletons."""
    if not HAVE_MPL:
        return None
    device = resolve_device(device)
    q = torch.as_tensor(rec["q"], device=device)
    idx = np.linspace(0, q.shape[0] - 1, n_snapshots).astype(int)
    fig, ax = plt.subplots(figsize=(8, 8))
    _draw_obstacles(ax, rec, 0.35)
    _, pw_all = forward_kinematics(spec, q)
    pw_all = to_numpy(pw_all)
    for s, i in enumerate(idx):
        pts = np.concatenate([[[0, 0, 0]], pw_all[i]], axis=0)
        ax.plot(pts[:, 0], pts[:, 1], "-o", ms=2, lw=1,
                alpha=0.3 + 0.7 * s / max(len(idx) - 1, 1), color="tab:blue")
    ee = pw_all[:, -1]
    ax.plot(ee[:, 0], ee[:, 1], "k-", lw=0.8, label="EE path")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend()
    ax.set_title("top-down world view")
    return _save(fig, out_path)


def plot_constraint_traces(rec: dict, spec, out_path, cfg=None, dtype=torch.float64,
                           device=None):
    """Per-iteration constraint traces (the `post_sim_plotting.m` family
    that replays `armour_constraints.out`): the max collision constraint
    value and the worst torque margin utilization (|u_nom| against limit -
    radius) of every recorded replan at the recorded k
    (``constraint_traces``).  Feasible iterations must sit below the
    acceptance thresholds; the figure makes the planner's safety margins
    visible over a whole episode."""
    if not HAVE_MPL or "q0p" not in rec or rec["k"].shape[0] == 0:
        return None
    cfg = cfg or PlannerConfig()
    col_max, tor_util, feas, _ = constraint_traces(rec, spec, cfg, dtype, device)
    fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    it = np.arange(len(col_max))
    axes[0].plot(it, col_max, "-o", ms=3, lw=0.9, color="tab:blue")
    axes[0].axhline(cfg.collision_violation_threshold, color="r", ls="--", lw=1,
                    label="acceptance threshold")
    axes[0].set_ylabel("max collision constraint (m)")
    axes[0].legend(fontsize=8)
    axes[1].plot(it, tor_util, "-o", ms=3, lw=0.9, color="tab:orange")
    axes[1].axhline(0.0, color="r", ls="--", lw=1, label="limit - planned radius")
    axes[1].set_ylabel("worst torque utilization (Nm)")
    axes[1].set_xlabel("replan iteration")
    axes[1].legend(fontsize=8)
    for ax in axes:
        for i in np.nonzero(~feas)[0]:
            ax.axvspan(i - 0.5, i + 0.5, color="gray", alpha=0.25)
    axes[0].set_title("per-iteration constraint traces at the executed k "
                      "(gray: infeasible replans -> braking fallback)")
    return _save(fig, out_path)


def plot_frs_overlay(rec: dict, spec, out_path, iterations=None, cfg=None,
                     dtype=torch.float64, device=None):
    """Per-iteration FRS overlay over a whole recorded episode (the
    remaining `post_sim_plotting.m` reachable-set family): the sliced
    forward-occupancy envelope of EVERY selected replan drawn over the
    obstacles and the executed end-effector path, color-graded by
    iteration; shows the swept certified volume of the episode."""
    if not HAVE_MPL or "q0p" not in rec or rec["k"].shape[0] == 0:
        return None
    device = resolve_device(device)
    n_it = rec["k"].shape[0]
    if iterations is None:
        iterations = list(range(0, n_it, max(1, n_it // 12)))
    centers, half = sliced_frs(rec, spec, iterations, cfg, dtype, device)

    fig, ax = plt.subplots(figsize=(9, 9))
    _draw_obstacles(ax, rec, 0.4)
    cmap = plt.get_cmap("viridis")
    T = centers.shape[1]
    for n in range(len(iterations)):
        color = cmap(n / max(len(iterations) - 1, 1))
        for t in range(0, T, max(1, T // 8)):
            for L in range(centers.shape[2]):
                c, h = centers[n, t, L], half[n, t, L]
                ax.add_patch(plt.Rectangle((c[0] - h[0], c[1] - h[1]), 2 * h[0], 2 * h[1],
                                           fill=False, lw=0.35, alpha=0.5, color=color))
    ee = _ee_path(spec, rec["q"], dtype, device)
    ax.plot(ee[:, 0], ee[:, 1], "k-", lw=1.1, label="executed EE path")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend()
    ax.set_title(f"per-iteration FRS overlay ({len(iterations)} replans, "
                 "dark -> light = episode time)")
    return _save(fig, out_path)


def plot_joint_limits(rec: dict, spec, out_path):
    """Per-joint position & velocity traces against the hard limits
    (`post_sim_plotting.m` state-limit family; the 10 ms post-hoc
    joint_limit_check of `uarmtd_agent.m:622-664` visualized).

    Continuous joints (no position limit) show the position trace without
    limit lines; every joint shows the symmetric speed limit band.
    """
    if not HAVE_MPL:
        return None
    t = rec["t"]
    q, qd = rec["q"], rec["qd"]
    nf = q.shape[1]
    lb = np.asarray(spec.pos_limits_lb, float)
    ub = np.asarray(spec.pos_limits_ub, float)
    spd = np.asarray(spec.speed_limits, float)
    fig, axes = plt.subplots(2, nf, figsize=(3 * nf, 6), sharex=True)
    for j in range(nf):
        ax = axes[0, j]
        ax.plot(t, q[:, j], lw=0.8)
        # continuous joints carry a large sentinel instead of a real
        # position limit (KinovaWithoutGripperInfo.h leaves them
        # unbounded): drawing it would flatten the trace's y-scale
        for lim in (lb[j], ub[j]):
            if np.isfinite(lim) and abs(lim) < 50.0:
                ax.axhline(lim, color="r", ls="--", lw=1)
        ax.set_title(f"joint {j + 1}", fontsize=9)
        if j == 0:
            ax.set_ylabel("position (rad)")
        ax = axes[1, j]
        ax.plot(t, qd[:, j], lw=0.8)
        ax.axhline(spd[j], color="r", ls="--", lw=1)
        ax.axhline(-spd[j], color="r", ls="--", lw=1)
        ax.set_xlabel("time (s)")
        if j == 0:
            ax.set_ylabel("velocity (rad/s)")
    fig.suptitle("joint positions / velocities vs limits")
    return _save(fig, out_path)


def plot_grasp_wrench(spec, grasp, q_fn, out_path, duration: float = 1.0,
                      n_samples: int = 200, device=None):
    """Contact-wrench figure family for grasp ("waiter-task") plans: the
    reference's force/ZMP figures (`post_sim_plotting.m` figure(3) forces,
    figure(401)/figure(9) ZMP position in the contact area), drawn from
    ``grasp_wrench``.  ``q_fn(t) -> q``: the realized joint trajectory (e.g.
    a closure over `bezier_ref` with the planned k)."""
    if not HAVE_MPL:
        return None
    ts, Fz, fric, zmp = grasp_wrench(spec, grasp, q_fn, duration, n_samples, device)
    fig = plt.figure(figsize=(12, 4))
    ax = fig.add_subplot(1, 3, 1)
    ax.plot(ts, Fz, lw=1.2)
    ax.axhline(0.0, color="r", ls="--", lw=1)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("Fz (N)")
    ax.set_title("separation force (must stay > 0)")
    ax = fig.add_subplot(1, 3, 2)
    ax.plot(ts, fric, lw=1.2)
    ax.axhline(1.0, color="r", ls="--", lw=1)
    ax.set_xlabel("time (s)")
    ax.set_ylabel(r"$|F_{xy}| / (\mu_s F_z)$")
    ax.set_title("friction-cone ratio (must stay < 1)")
    ax = fig.add_subplot(1, 3, 3)
    th = np.linspace(0, 2 * np.pi, 100)
    ax.plot(grasp.surf_rad * np.cos(th), grasp.surf_rad * np.sin(th), "r--", lw=1)
    sc = ax.scatter(zmp[:, 0], zmp[:, 1], c=ts, s=6, cmap="viridis")
    fig.colorbar(sc, ax=ax, label="time (s)")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title("ZMP in contact area")
    return _save(fig, out_path)


def plot_frs_animation_frames(rec: dict, spec, out_dir, cfg=None, dtype=torch.float64,
                              device=None, max_frames: int = 12):
    """Per-iteration FRS animation frames (the `post_sim_plotting.m`
    animation-loop family, frames 1..N of the replanned forward occupancy
    over the world): one ``plot_frs_topdown`` snapshot per recorded planning
    iteration, strided to at most ``max_frames`` files ``frame_000.png ...``
    in ``out_dir``; the frames' iterations are rebuilt as one batch.
    Assemble with any encoder, e.g. `ffmpeg -i frame_%03d.png out.mp4`."""
    if not HAVE_MPL or "q0p" not in rec:
        return None
    device = resolve_device(device)
    n = int(rec["k"].shape[0])
    stride = max(1, -(-n // max_frames))
    its = list(range(0, n, stride))
    os.makedirs(out_dir, exist_ok=True)
    if not its:
        return []
    centers, half = sliced_frs(rec, spec, its, cfg, dtype, device)
    ee = _ee_path(spec, rec["q"], dtype, device)
    return [_draw_frs_topdown(rec, os.path.join(out_dir, f"frame_{j:03d}.png"), it,
                              centers[j], half[j], ee)
            for j, it in enumerate(its)]
