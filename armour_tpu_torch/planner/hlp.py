"""High-level planners (waypoint generators).

Port of `armour_tpu/planner/hlp.py`, the rebuild of
`simulator/planners/high_level_planners/`:

- ``straight_line_waypoint``: the default HLP of every reference benchmark
  (`robot_arm_straight_line_HLP.m:44-57`), batched over leading dims.
- ``clearance_waypoint``: sampled waypoint selection, batched over worlds:
  perturbs the straight-line direction with M candidates, rejects colliding
  arm configurations (inflated obstacles), scores progress to the goal.
- ``rrt_waypoints``, ``rrt_star_waypoints`` (`RRT_star_HLP.m`),
  ``rrt_connect_waypoints`` (`RRT_connect_HLP.m`), ``prm_waypoints`` (PRM +
  Dijkstra): host numpy configuration-space planners over the pure-numpy
  collision query ``_host_checker``; run before or during an episode, their
  paths are consumed waypoint by waypoint.
- ``ee_rrt_star_waypoints`` / ``ik_to_position`` /
  ``ee_rrt_star_config_waypoints``: workspace RRT* over end-effector
  positions with buffered point-in-box edge checks, mapped back to
  configuration waypoints by damped-least-squares IK seeded from
  0.5 (q_cur + q_goal) with global-goal fallback
  (`arm_end_effector_RRT_star_HLP.m:1-145`).  Their end-effector and IK
  evaluations run on CPU float64 tensors: the host loop never touches the
  card.
- ``ManualWaypointHLP`` and ``optimization_waypoint``
  (`robot_arm_optimization_HLP.m:102-140`, on ``planner/nlp.py``).

The numpy planners are copied from the JAX package line for line, so the
same seed gives the same path.  The samples of ``clearance_waypoint`` come
from a ``torch.Generator``, or from a given ``noise`` tensor (tests pass
the JAX package's ``jax.random.normal`` draws).
"""

from __future__ import annotations

import heapq
import time

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.device import resolve_device, to_numpy
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.dynamics.utility import ee_jacobian, ee_pose
from armour_tpu_torch.planner.armour import wrap_to_pi
from armour_tpu_torch.planner.nlp import solve_box_alm
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.sim.world import arm_collision_check


def _joint_box(spec: RobotSpec):
    """Sampling box of the configuration planners: [-pi, pi] on continuous
    joints, the position limits elsewhere."""
    lb = np.where(spec.continuous_joints, -np.pi, spec.pos_limits_lb)
    ub = np.where(spec.continuous_joints, np.pi, spec.pos_limits_ub)
    return lb, ub


def _np_forward_kinematics(spec: RobotSpec, q: np.ndarray):
    """Pure-numpy world-frame (R_w, p_w): the host twin of
    `dynamics/rnea.py::forward_kinematics`."""
    N = q.shape[0]
    fixed = spec.fixed_rotations()
    Rw = np.broadcast_to(np.eye(3), (N, 3, 3)).copy()
    pw = np.zeros((N, 3))
    Rws, pws = [], []
    for i in range(spec.n_joints):
        pw = pw + Rw @ spec.trans[i]
        axis = int(spec.axes[i])
        if axis != 0:
            c = np.cos(q[:, i])
            s = (1.0 if axis > 0 else -1.0) * np.sin(q[:, i])
            a = abs(axis) - 1
            R = np.zeros((N, 3, 3))
            if a == 0:
                R[:, 0, 0] = 1
                R[:, 1, 1], R[:, 1, 2] = c, -s
                R[:, 2, 1], R[:, 2, 2] = s, c
            elif a == 1:
                R[:, 0, 0], R[:, 0, 2] = c, s
                R[:, 1, 1] = 1
                R[:, 2, 0], R[:, 2, 2] = -s, c
            else:
                R[:, 0, 0], R[:, 0, 1] = c, -s
                R[:, 1, 0], R[:, 1, 1] = s, c
                R[:, 2, 2] = 1
            Ri = fixed[i] @ R
        else:
            Ri = np.broadcast_to(fixed[i], (N, 3, 3))
        Rw = Rw @ Ri
        Rws.append(Rw)
        pws.append(pw)
    return np.stack(Rws, axis=1), np.stack(pws, axis=1)


def _host_checker(spec: RobotSpec, obstacles: ObstacleSet):
    """Pure-numpy batched arm-vs-obstacle query for the host-side RRT
    planners (the semantics of `sim/world.py::arm_collision_check`: SAT
    between each link's oriented box and each obstacle AABB).

    The planners make thousands of small queries; numpy answers each in
    microseconds, where a device round trip per query would dominate."""
    z = to_numpy(obstacles.zonos).astype(float)
    live = to_numpy(obstacles.mask).astype(bool)
    obs_c = z[live, 0]                                  # (O, 3)
    obs_half = np.abs(z[live, 1:]).sum(axis=1)          # (O, 3)
    half = np.asarray(spec.link_zono_gen, float)        # (L, 3)
    c_loc = np.asarray(spec.link_zono_center, float)    # (L, 3)

    def query(qs):
        qs = np.atleast_2d(np.asarray(qs, float))
        N = qs.shape[0]
        if obs_c.shape[0] == 0:
            return np.zeros(N, bool)
        Rw, pw = _np_forward_kinematics(spec, qs)       # (N,L,3,3), (N,L,3)
        obb_c = np.einsum("nlij,lj->nli", Rw, c_loc) + pw
        d = obb_c[:, :, None] - obs_c[None, None]       # (N, L, O, 3)
        Rb = Rw[:, :, None]                             # (N, L, 1, 3, 3)
        sep = np.zeros(d.shape[:-1], bool)
        eye = np.eye(3)
        # 15 SAT axes: world, OBB columns, cross products
        axes = [np.broadcast_to(eye[i], d.shape) for i in range(3)]
        axes += [np.broadcast_to(Rb[..., :, i], d.shape) for i in range(3)]
        for i in range(3):
            for j in range(3):
                axes.append(np.cross(Rb[..., :, i], eye[j]))
        for L_ax in axes:
            norm = np.linalg.norm(L_ax, axis=-1, keepdims=True)
            Ln = np.divide(L_ax, norm, out=np.zeros_like(L_ax),
                           where=norm > 1e-9)
            dist = np.abs((d * Ln).sum(-1))
            r_obb = (np.abs(np.einsum("nloi,nloij->nloj", Ln,
                                      np.broadcast_to(Rb, d.shape + (3,))))
                     * half[None, :, None]).sum(-1)
            r_aabb = (np.abs(Ln) * obs_half[None, None]).sum(-1)
            sep |= (dist > r_obb + r_aabb) & (norm[..., 0] > 1e-9)
        return (~sep).any(axis=(1, 2))

    return query


def straight_line_waypoint(spec: RobotSpec, q_cur, goal, lookahead: float = 1.0):
    """q_cur + lookahead * unit(goal - q_cur), angdiff on continuous joints;
    batched over the leading dims of q_cur (..., nf)."""
    d = goal - q_cur
    d = torch.where(torch.as_tensor(spec.continuous_joints, device=d.device), wrap_to_pi(d), d)
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return q_cur + lookahead * d / torch.where(norm > 1e-9, norm, 1.0)


def clearance_waypoint(
    spec: RobotSpec,
    q_cur,
    goal,
    obstacles: ObstacleSet,
    generator: torch.Generator | None = None,
    noise=None,
    lookahead: float = 1.0,
    n_samples: int = 32,
    sigma: float = 0.4,
    inflate: float = 0.05,
):
    """Pick the collision-free candidate closest to the goal direction.

    q_cur, goal (..., nf); obstacles.zonos (..., O, 4, 3), mask (..., O):
    one world per leading index.  Candidates: the straight-line waypoint
    plus n_samples Gaussian perturbations, ``sigma * noise`` with ``noise``
    (..., n_samples, nf) standard normal, drawn from ``generator`` when not
    given.  Colliding candidates (arm posed at the candidate, obstacles
    inflated by ``inflate``) are discarded; ties broken by distance to goal.
    """
    base = straight_line_waypoint(spec, q_cur, goal, lookahead)
    if noise is None:
        noise = torch.randn(base.shape[:-1] + (n_samples, spec.n_factors),
                            generator=generator, dtype=base.dtype, device=base.device)
    noise = torch.as_tensor(noise, dtype=base.dtype, device=base.device)
    cands = torch.cat([base[..., None, :], base[..., None, :] + sigma * noise], dim=-2)

    zon = obstacles.zonos
    infl = zon.clone()
    infl[..., 1:, :] += torch.eye(3, dtype=zon.dtype, device=zon.device) * inflate
    obs_inflated = ObstacleSet(infl[..., None, :, :, :], obstacles.mask[..., None, :])
    hits = arm_collision_check(spec, cands, obs_inflated)                # (..., M+1)

    d = cands - goal[..., None, :]
    d = torch.where(torch.as_tensor(spec.continuous_joints, device=d.device), wrap_to_pi(d), d)
    dist = torch.linalg.vector_norm(d, dim=-1)
    # prefer the pure straight-line candidate slightly (index 0)
    dist[..., 0] += -1e-3
    score = torch.where(hits, torch.inf, dist)
    best = torch.argmin(score, dim=-1, keepdim=True)                     # (..., 1)
    pick = torch.gather(cands, -2, best[..., None].expand(best.shape + (spec.n_factors,)))[..., 0, :]
    # if everything collides, fall back to the straight-line waypoint
    return torch.where(torch.isinf(torch.gather(score, -1, best)), base, pick)


def rrt_waypoints(
    spec: RobotSpec,
    start: np.ndarray,
    goal: np.ndarray,
    obstacles: ObstacleSet,
    seed: int = 0,
    max_nodes: int = 2000,
    step: float = 0.3,
    goal_bias: float = 0.2,
    batch: int = 64,
) -> np.ndarray | None:
    """Host-side config-space RRT (`RRT_HLP.m:1-120` modes 'new').

    Returns a (n_waypoints, nf) path from start to goal, or None on failure.
    """
    nf = spec.n_factors
    rng = np.random.default_rng(seed)
    lb, ub = _joint_box(spec)

    check = _host_checker(spec, obstacles)

    nodes = np.zeros((max_nodes, nf))
    parent = np.full(max_nodes, -1, np.int64)
    nodes[0] = start
    n = 1
    goal = np.asarray(goal)

    while n < max_nodes:
        # propose a batch of extensions
        targets = np.where(
            rng.uniform(size=(batch, 1)) < goal_bias,
            goal[None, :],
            rng.uniform(lb, ub, (batch, nf)),
        )
        d = targets[:, None, :] - nodes[None, :n, :]
        dist = np.linalg.norm(d, axis=-1)
        nearest = np.argmin(dist, axis=1)
        dirs = targets - nodes[nearest]
        norms = np.linalg.norm(dirs, axis=-1, keepdims=True)
        new = nodes[nearest] + step * dirs / np.maximum(norms, 1e-9)
        new = np.clip(new, lb, ub)
        # validate the new nodes and edge midpoints
        mids = 0.5 * (nodes[nearest] + new)
        hits = check(np.concatenate([new, mids]))
        ok = ~(hits[:batch] | hits[batch:])
        for i in np.nonzero(ok)[0]:
            if n >= max_nodes:
                break
            nodes[n] = new[i]
            parent[n] = nearest[i]
            if np.linalg.norm(new[i] - goal) < step:
                # trace back
                path = [goal, new[i]]
                p = parent[n]
                while p >= 0:
                    path.append(nodes[p])
                    p = parent[p]
                return np.asarray(path[::-1])
            n += 1
    return None


def _edge_free(check, a: np.ndarray, b: np.ndarray, resolution: float = 0.15):
    """Batched straight-edge collision check at fixed resolution (the
    reference buffers RRT* edges the same way,
    `arm_end_effector_RRT_star_HLP.m`)."""
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    seg = np.linalg.norm(b - a, axis=-1)
    n_steps = max(2, int(np.ceil(seg.max() / resolution)) + 1)
    ts = np.linspace(0.0, 1.0, n_steps)
    pts = a[:, None, :] + ts[None, :, None] * (b - a)[:, None, :]
    hits = check(pts.reshape(-1, a.shape[-1]))
    return ~hits.reshape(a.shape[0], n_steps).any(axis=1)


def rrt_star_waypoints(
    spec: RobotSpec,
    start: np.ndarray,
    goal: np.ndarray,
    obstacles: ObstacleSet,
    seed: int = 0,
    max_nodes: int = 800,
    step: float = 0.3,
    goal_bias: float = 0.2,
    rewire_radius: float = 0.6,
    time_budget_s: float | None = None,
) -> np.ndarray | None:
    """Config-space RRT* (`RRT_star_HLP.m`): RRT growth + choose-best-parent
    + radius rewiring, so the returned path cost is locally optimal.
    ``time_budget_s`` bounds wall time (battery escalations must not let a
    pathless world exhaust max_nodes for minutes)."""
    deadline = None if time_budget_s is None else time.monotonic() + time_budget_s
    nf = spec.n_factors
    rng = np.random.default_rng(seed)
    lb, ub = _joint_box(spec)
    check = _host_checker(spec, obstacles)

    nodes = np.zeros((max_nodes, nf))
    parent = np.full(max_nodes, -1, np.int64)
    cost = np.zeros(max_nodes)
    nodes[0] = start
    n = 1
    goal = np.asarray(goal)
    goal_idx = -1

    for it in range(max_nodes * 4):
        if n >= max_nodes:
            break
        if deadline is not None and it % 32 == 0 and time.monotonic() > deadline:
            break
        target = goal if rng.uniform() < goal_bias else rng.uniform(lb, ub)
        d = np.linalg.norm(nodes[:n] - target, axis=-1)
        nearest = int(np.argmin(d))
        dirv = target - nodes[nearest]
        nd = np.linalg.norm(dirv)
        new = nodes[nearest] + step * dirv / max(nd, 1e-9)
        new = np.clip(new, lb, ub)
        # candidate parents within the rewire radius
        dn = np.linalg.norm(nodes[:n] - new, axis=-1)
        near = np.nonzero(dn < rewire_radius)[0]
        if near.size == 0:
            near = np.array([nearest])
        free = _edge_free(check, nodes[near], np.broadcast_to(new, (near.size, nf)))
        if not free.any():
            continue
        cands = near[free]
        c_through = cost[cands] + np.linalg.norm(nodes[cands] - new, axis=-1)
        best = int(np.argmin(c_through))
        nodes[n] = new
        parent[n] = cands[best]
        cost[n] = c_through[best]
        # rewire: re-parent near nodes through the new node when cheaper
        improve = cost[cands] > cost[n] + np.linalg.norm(nodes[cands] - new, axis=-1)
        for j in cands[improve]:
            parent[j] = n
            cost[j] = cost[n] + np.linalg.norm(nodes[j] - new)
        if np.linalg.norm(new - goal) < step and _edge_free(check, new, goal)[0]:
            goal_idx = n
        n += 1
        if goal_idx >= 0:
            break

    if goal_idx < 0:
        return None
    path = [goal, nodes[goal_idx]]
    p = parent[goal_idx]
    while p >= 0:
        path.append(nodes[p])
        p = parent[p]
    return np.asarray(path[::-1])


def rrt_connect_waypoints(
    spec: RobotSpec,
    start: np.ndarray,
    goal: np.ndarray,
    obstacles: ObstacleSet,
    seed: int = 0,
    max_nodes: int = 1000,
    step: float = 0.3,
    time_budget_s: float | None = None,
) -> np.ndarray | None:
    """Bidirectional RRT (`RRT_connect_HLP.m`): grow trees from start and
    goal toward each other, greedily extending until they connect.
    ``time_budget_s`` bounds wall time on pathless worlds."""
    deadline = None if time_budget_s is None else time.monotonic() + time_budget_s
    rng = np.random.default_rng(seed)
    lb, ub = _joint_box(spec)
    check = _host_checker(spec, obstacles)

    trees = [
        {"nodes": [np.asarray(start, float)], "parent": [-1]},
        {"nodes": [np.asarray(goal, float)], "parent": [-1]},
    ]

    def extend(tree, target):
        pts = np.asarray(tree["nodes"])
        i = int(np.argmin(np.linalg.norm(pts - target, axis=-1)))
        dirv = target - pts[i]
        nd = np.linalg.norm(dirv)
        new = pts[i] + min(step, nd) * dirv / max(nd, 1e-9)
        new = np.clip(new, lb, ub)
        if not _edge_free(check, pts[i], new)[0]:
            return None
        tree["nodes"].append(new)
        tree["parent"].append(i)
        return new

    def trace(tree):
        path, p = [], len(tree["nodes"]) - 1
        while p >= 0:
            path.append(tree["nodes"][p])
            p = tree["parent"][p]
        return path

    for it in range(max_nodes):
        if deadline is not None and it % 32 == 0 and time.monotonic() > deadline:
            break
        a, b = trees[it % 2], trees[(it + 1) % 2]
        target = rng.uniform(lb, ub)
        new = extend(a, target)
        if new is None:
            continue
        # greedy connect from the other tree
        while True:
            joined = extend(b, new)
            if joined is None:
                break
            if np.linalg.norm(joined - new) < 1e-9:
                path = trace(a)[::-1] + trace(b)
                if it % 2 == 1:  # a was the goal tree
                    path = path[::-1]
                return np.asarray(path)

    return None


def ik_to_position(
    spec: RobotSpec,
    target_xyz,
    q_seed,
    iters: int = 60,
    damping: float = 1e-2,
    tol: float = 5e-3,
):
    """Damped-least-squares IK to end-effector positions (the workspace
    HLP's `agent_info.inverse_kinematics` role,
    `arm_end_effector_RRT_star_HLP.m:70-80`), batched over the leading dims
    of target_xyz (..., 3) and q_seed (..., nf); runs where q_seed lies.
    Returns (q (..., nf), ok (...,))."""
    q = torch.as_tensor(q_seed)
    dtype, dev = q.dtype, q.device
    lb, ub = (torch.as_tensor(x, dtype=dtype, device=dev) for x in _joint_box(spec))
    target = torch.as_tensor(target_xyz, dtype=dtype, device=dev)
    eye = torch.eye(3, dtype=dtype, device=dev)
    for _ in range(iters):
        _, p = ee_pose(spec, q)
        J = ee_jacobian(spec, q)[..., :3, :]                  # position rows (..., 3, nf)
        e = target - p
        JJt = J @ J.transpose(-1, -2) + damping * eye
        dq = (J.transpose(-1, -2) @ torch.linalg.solve(JJt, e[..., None]))[..., 0]
        q = torch.clamp(q + dq, lb, ub)
    _, p = ee_pose(spec, q)
    ok = torch.linalg.vector_norm(target - p, dim=-1) <= tol
    return q, ok


def _ee_position(spec: RobotSpec, q) -> np.ndarray:
    """End-effector position of one configuration, on a CPU float64 tensor."""
    return ee_pose(spec, torch.as_tensor(np.asarray(q, float), dtype=torch.float64))[1].numpy()


def ee_rrt_star_waypoints(
    spec: RobotSpec,
    q_start: np.ndarray,
    goal,
    obstacles: ObstacleSet,
    seed: int = 0,
    max_nodes: int = 600,
    step: float = 0.1,
    goal_bias: float = 0.2,
    rewire_radius: float = 0.25,
    buffer: float = 0.0,
    bounds=((-1.0, 1.0), (-1.0, 1.0), (0.0, 1.3)),
    edge_resolution: float = 0.01,
) -> np.ndarray | None:
    """Workspace RRT* over END-EFFECTOR positions
    (`arm_end_effector_RRT_star_HLP.m`): nodes are 3-D points, edges are
    checked by point-vs-buffered-box distance at 1 cm discretization
    (`edge_feasibility_check`, `:128-145`), obstacles grow by 2*buffer
    (`grow_tree`, `:108-118`).  Returns an (n_wp, 3) EE path start -> goal,
    or None.

    ``goal``: either a goal configuration (nf,) — its EE position is used,
    matching `setup@:27-37` — or a 3-D point.
    """
    rng = np.random.default_rng(seed)
    goal = np.asarray(goal, float)
    start = _ee_position(spec, q_start)
    goal_p = _ee_position(spec, goal) if goal.shape[-1] == spec.n_factors else goal

    z = to_numpy(obstacles.zonos).astype(float)
    live = to_numpy(obstacles.mask).astype(bool)
    obs_c = z[live, 0]                                   # (n_obs, 3)
    obs_h = np.abs(z[live, 1:]).sum(axis=1) + buffer     # (n_obs, 3)
    lb = np.array([b[0] for b in bounds])
    ub = np.array([b[1] for b in bounds])

    def pts_free(pts):
        """(N, 3) points vs all buffered boxes (dist_point_to_box == 0)."""
        if obs_c.shape[0] == 0:
            return np.ones(pts.shape[0], bool)
        inside = np.all(
            np.abs(pts[:, None, :] - obs_c[None]) <= obs_h[None], axis=-1
        )
        return ~inside.any(axis=1)

    def edge_free(a, b):
        d = np.linalg.norm(b - a)
        n = max(2, int(np.ceil(d / edge_resolution)) + 1)
        ts = np.linspace(0.0, 1.0, n)[:, None]
        return pts_free(a[None] + ts * (b - a)[None]).all()

    nodes = np.zeros((max_nodes, 3))
    parent = np.full(max_nodes, -1, np.int64)
    cost = np.zeros(max_nodes)
    nodes[0] = start
    n = 1
    goal_idx = -1
    for _ in range(max_nodes * 4):
        if n >= max_nodes:
            break
        target = goal_p if rng.uniform() < goal_bias else rng.uniform(lb, ub)
        nearest = int(np.argmin(np.linalg.norm(nodes[:n] - target, axis=-1)))
        dirv = target - nodes[nearest]
        nd = np.linalg.norm(dirv)
        new = nodes[nearest] + min(step, nd) * dirv / max(nd, 1e-9)
        new = np.clip(new, lb, ub)
        if not pts_free(new[None])[0]:
            continue
        dn = np.linalg.norm(nodes[:n] - new, axis=-1)
        near = np.nonzero(dn < rewire_radius)[0]
        if near.size == 0:
            near = np.array([nearest])
        free = np.array([edge_free(nodes[j], new) for j in near])
        if not free.any():
            continue
        cands = near[free]
        c_through = cost[cands] + np.linalg.norm(nodes[cands] - new, axis=-1)
        best = int(np.argmin(c_through))
        nodes[n] = new
        parent[n] = cands[best]
        cost[n] = c_through[best]
        improve = cost[cands] > cost[n] + np.linalg.norm(nodes[cands] - new, axis=-1)
        for j in cands[improve]:
            parent[j] = n
            cost[j] = cost[n] + np.linalg.norm(nodes[j] - new)
        if np.linalg.norm(new - goal_p) < step and edge_free(new, goal_p):
            goal_idx = n
        n += 1
        if goal_idx >= 0:
            break
    if goal_idx < 0:
        return None
    path = [goal_p, nodes[goal_idx]]
    p = parent[goal_idx]
    while p >= 0:
        path.append(nodes[p])
        p = parent[p]
    return np.asarray(path[::-1])


def ee_rrt_star_config_waypoints(
    spec: RobotSpec,
    q_start: np.ndarray,
    goal_cfg: np.ndarray,
    obstacles: ObstacleSet,
    seed: int = 0,
    **rrt_kwargs,
) -> np.ndarray | None:
    """EE RRT* path mapped to CONFIGURATION waypoints: each workspace
    waypoint goes through damped-least-squares IK seeded from
    0.5 (q_cur + q_goal); IK failure falls back to the global goal config
    (`arm_end_effector_RRT_star_HLP.m:60-86` get_waypoint)."""
    path = ee_rrt_star_waypoints(spec, q_start, goal_cfg, obstacles,
                                 seed=seed, **rrt_kwargs)
    if path is None:
        return None
    goal_cfg = np.asarray(goal_cfg, float)
    out = []
    q_cur = np.asarray(q_start, float)
    for z in path[1:]:
        seed_q = torch.as_tensor(0.5 * (q_cur + goal_cfg), dtype=torch.float64)
        q, ok = ik_to_position(spec, z, seed_q)
        q = q.numpy() if bool(ok) else goal_cfg
        out.append(q)
        q_cur = q
    out.append(goal_cfg)
    return np.asarray(out)


def prm_waypoints(
    spec: RobotSpec,
    start: np.ndarray,
    goal: np.ndarray,
    obstacles: ObstacleSet,
    seed: int = 0,
    n_samples: int = 300,
    k_neighbors: int = 8,
) -> np.ndarray | None:
    """Probabilistic roadmap + Dijkstra (the reference's PRM/dijkstra HLP
    family): sample free configurations, connect k-nearest collision-free
    edges, shortest-path start -> goal."""
    nf = spec.n_factors
    rng = np.random.default_rng(seed)
    lb, ub = _joint_box(spec)
    check = _host_checker(spec, obstacles)

    samples = rng.uniform(lb, ub, (n_samples, nf))
    free = ~check(samples)
    nodes = np.concatenate([[np.asarray(start, float)], [np.asarray(goal, float)],
                            samples[free]])
    N = nodes.shape[0]
    dist = np.linalg.norm(nodes[:, None, :] - nodes[None, :, :], axis=-1)
    np.fill_diagonal(dist, np.inf)
    adj: list[list[tuple[int, float]]] = [[] for _ in range(N)]
    # batched edge validation, k nearest per node
    pairs = []
    for i in range(N):
        for j in np.argsort(dist[i])[:k_neighbors]:
            if i < j:
                pairs.append((i, int(j)))
    pairs = np.asarray(pairs)
    ok = _edge_free(check, nodes[pairs[:, 0]], nodes[pairs[:, 1]])
    for (i, j), good in zip(pairs, ok):
        if good:
            adj[i].append((j, dist[i, j]))
            adj[j].append((i, dist[i, j]))

    # Dijkstra start (0) -> goal (1)
    D = np.full(N, np.inf)
    prev = np.full(N, -1, np.int64)
    D[0] = 0.0
    heap = [(0.0, 0)]
    while heap:
        d0, i = heapq.heappop(heap)
        if d0 > D[i]:
            continue
        if i == 1:
            break
        for j, w in adj[i]:
            nd = d0 + w
            if nd < D[j]:
                D[j] = nd
                prev[j] = i
                heapq.heappush(heap, (nd, j))
    if not np.isfinite(D[1]):
        return None
    path, p = [], 1
    while p >= 0:
        path.append(nodes[p])
        p = prev[p]
    return np.asarray(path[::-1])


class ManualWaypointHLP:
    """User-supplied waypoint sequence, consumed in order
    (`arm_manual_waypoint_HLP.m` / `manual_waypoint_HLP.m:30-55`, without
    the MATLAB plotting): ``get_waypoint`` returns the current waypoint and
    advances when the query configuration comes within ``advance_radius``
    of it; the final waypoint is returned forever.

    The battery driver consumes its guidance paths through the same rule
    (`sim/harness.py`); this class is the library surface for callers
    scripting their own episode loop."""

    def __init__(self, waypoints, advance_radius: float = 0.35):
        self.waypoints = np.atleast_2d(np.asarray(waypoints, float))
        self.advance_radius = float(advance_radius)
        self.index = 0

    def get_waypoint(self, q_cur) -> np.ndarray:
        q_cur = to_numpy(q_cur).astype(float)
        while (self.index < len(self.waypoints) - 1
               and np.linalg.norm(q_cur - self.waypoints[self.index])
               < self.advance_radius):
            self.index += 1
        return self.waypoints[self.index]


def optimization_waypoint(
    spec: RobotSpec,
    q_start,
    q_goal,
    obstacles: ObstacleSet,
    buffer_dist: float = 0.1,
    outer_iters: int = 8,
    inner_iters: int = 10,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """ONE intermediate waypoint configuration found by a small NLP
    (`robot_arm_optimization_HLP.m:102-140`): minimize the summed squared
    end-effector distances to the start and goal EE positions, subject to
    every joint location staying >= ``buffer_dist`` outside every obstacle
    AABB (`dist_point_to_box` role) and inside the joint position limits.
    The reference calls fmincon; here the same 7-variable problem goes to
    ``planner/nlp.py::solve_box_alm`` with the box mapped onto [-1, 1]^n.

    Returns ``(waypoint (n,) numpy, ok)``; ``ok`` False mirrors the
    reference's exitflag <= 0 path (the caller falls back to the goal).
    """
    dev = resolve_device(device)
    q_start = to_numpy(q_start).astype(float)
    q_goal = to_numpy(q_goal).astype(float)
    lb = np.where(np.isfinite(spec.pos_limits_lb), spec.pos_limits_lb, -np.pi)
    ub = np.where(np.isfinite(spec.pos_limits_ub), spec.pos_limits_ub, np.pi)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    center, half = t(0.5 * (lb + ub)), t(0.5 * (ub - lb))
    zonos = t(to_numpy(obstacles.zonos))
    obs_c = zonos[:, 0]
    obs_h = zonos[:, 1:].abs().sum(1)
    mask = torch.as_tensor(to_numpy(obstacles.mask), device=dev)
    ee_s = ee_pose(spec, t(q_start))[1]
    ee_g = ee_pose(spec, t(q_goal))[1]

    def x_of(k):
        return center + half * k

    def f_fn(k):
        p = ee_pose(spec, x_of(k))[1]
        return torch.sum((p - ee_g) ** 2, -1) + torch.sum((p - ee_s) ** 2, -1)

    def c_fn(k):
        _, pw = forward_kinematics(spec, x_of(k))                   # (..., n_joints, 3)
        d = torch.clamp((pw[..., :, None, :] - obs_c).abs() - obs_h, min=0.0)
        dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)          # (..., n_joints, O)
        return torch.where(mask, buffer_dist - dist, -1.0).flatten(-2)

    k0 = torch.clamp((t(0.5 * (q_start + q_goal)) - center) / half, -1.0, 1.0)
    res = solve_box_alm(f_fn, c_fn, k0, outer_iters=outer_iters, inner_iters=inner_iters)
    found = bool(res.found_feas)
    k = res.k_feas if found else res.k
    ok = found or bool(res.max_violation <= 1e-6)
    return x_of(k).cpu().numpy().astype(float), ok
