"""Scenario library: CSV world IO, random-world generation, hard scenes.

Port of `armour_tpu/sim/scenarios.py`: the CSV world format of
`load_saved_world.m:1-16` (row 1 start, row 2 goal, row 3 NaN, rows 4+ =
obstacle [center, side_lengths]), `kinova_create_random_worlds.m`-style
random suites, and the 7 curated hard scenarios of
`get_kinova_scenario_info.m:1-262` (table, doorway, posts, shelves, inside
box, sink-to-cupboard, window), including the fetch->kinova frame
transform (`get_kinova_scenario_info.m:256-262`).

Scene construction is host numpy; a `World` holds torch tensors on the
device its loader was given.  The random suite draws from a numpy
``Generator``, so it matches the JAX package draw for draw; its rejection
screen runs on CPU float64 tensors.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.device import resolve_device, to_numpy
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.sim.world import World, arm_collision_check

PI = math.pi


def _world(start, goal, centers, sides, capacity: int, dtype, device) -> World:
    """A World on ``device`` from numpy start/goal and box centers/sides."""
    dev = resolve_device(device)
    obs = ObstacleSet.from_boxes(centers, sides, capacity)
    return World(
        start=torch.as_tensor(np.asarray(start, float), dtype=dtype, device=dev),
        goal=torch.as_tensor(np.asarray(goal, float), dtype=dtype, device=dev),
        obstacles=ObstacleSet(torch.as_tensor(obs.zonos, dtype=dtype, device=dev),
                              torch.as_tensor(obs.mask, device=dev)),
    )


# ---------------------------------------------------------------------------
# CSV world IO (format of load_saved_world.m)
# ---------------------------------------------------------------------------

def load_world_csv(path, capacity: int, dtype: torch.dtype = torch.float64, device=None) -> World:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) if x.lower() != "nan" else np.nan
                             for x in line.split(",")])
    centers = [r[0:3] for r in rows[3:]]
    sides = [r[3:6] for r in rows[3:]]
    return _world(rows[0], rows[1], np.asarray(centers), np.asarray(sides), capacity, dtype, device)


def save_world_csv(path, start, goal, centers, sides):
    n = len(start)
    with open(path, "w") as f:
        f.write(",".join(f"{x:.6g}" for x in start) + "\n")
        f.write(",".join(f"{x:.6g}" for x in goal) + "\n")
        f.write(",".join(["NaN"] * n) + "\n")
        for c, s in zip(centers, sides):
            row = list(c) + list(s) + [np.nan] * (n - 6)
            f.write(",".join("NaN" if np.isnan(x) else f"{x:.6g}" for x in row) + "\n")


# ---------------------------------------------------------------------------
# random world suite
# ---------------------------------------------------------------------------

def generate_random_world(
    spec: RobotSpec,
    rng: np.random.Generator,
    n_obstacles: int,
    capacity: int,
    max_attempts: int = 200,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> World:
    """Random start/goal + obstacles with rejection sampling so that the arm
    at start and goal is collision-free with a safety buffer
    (`arm_world_static.m:154-264`).  The screens run on ``device``, where
    the world is returned."""
    dev = resolve_device(device)
    lb = np.where(spec.continuous_joints, -PI, spec.pos_limits_lb + 0.1)
    ub = np.where(spec.continuous_joints, PI, spec.pos_limits_ub - 0.1)

    start = rng.uniform(lb, ub)
    goal = rng.uniform(lb, ub)
    qs = torch.as_tensor(np.stack([start, goal]), dtype=torch.float64, device=dev)

    centers, sides = [], []
    attempts = 0
    while len(centers) < n_obstacles and attempts < max_attempts * n_obstacles:
        attempts += 1
        c = rng.uniform(-0.85, 0.85, 3)
        c[2] = abs(c[2]) + 0.05
        s = rng.uniform(0.05, 0.45, 3)
        cand = ObstacleSet.from_boxes(np.asarray(centers + [c]),
                                      np.asarray(sides + [s + 0.15]),  # creation buffer
                                      len(centers) + 1)
        obs = ObstacleSet(torch.as_tensor(cand.zonos, device=dev), torch.as_tensor(cand.mask, device=dev))
        if bool(arm_collision_check(spec, qs, obs).any()):
            continue
        centers.append(c)
        sides.append(s)
    return _world(start, goal, np.asarray(centers), np.asarray(sides), capacity, dtype, dev)


def generate_world_suite(
    spec: RobotSpec,
    out_dir,
    n_worlds: int = 100,
    obstacle_counts=(10, 20, 40),
    capacity: int = 40,
    seed: int = 0,
    device="cpu",
):
    """Generate and persist a benchmark suite (the analog of
    `saved_worlds/random/` x 100 CSVs, freshly sampled).  The sampling is
    host work; the collision screens run on ``device`` (the CPU unless
    given: `generate_worlds` passes the card)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_worlds):
        n_obs = obstacle_counts[i % len(obstacle_counts)]
        w = generate_random_world(spec, rng, n_obs, capacity, device=device)
        zon = to_numpy(w.obstacles.zonos)
        live = to_numpy(w.obstacles.mask)
        centers = zon[live, 0, :]
        sides = np.abs(zon[live, 1:, :]).sum(axis=1) * 2.0
        p = out / f"scene_{n_obs:03d}_{i + 1:03d}.csv"
        save_world_csv(p, to_numpy(w.start), to_numpy(w.goal), centers, sides)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# hard scenarios (get_kinova_scenario_info.m)
# ---------------------------------------------------------------------------

def _fetch_to_kinova(boxes):
    """Frame transform from the fetch-world scene layout to the kinova base
    (`get_kinova_scenario_info.m:256-262`)."""
    out = []
    for c, s in boxes:
        out.append((
            [c[2] - 0.8, c[1], c[0] + 0.25],
            [s[2], s[1], s[0]],
        ))
    return out


def _shelf(center, height, width, depth, n_shelves, min_h, max_h, direction):
    """(make_shelf_obstacle.m) -> list of (center, side_lengths)."""
    t = 0.01
    boxes = []
    cx, cy, cz = center
    if direction == 1:
        boxes.append(([cx, cy - width / 2, cz], [depth, t, height]))
        boxes.append(([cx, cy + width / 2, cz], [depth, t, height]))
        plate = [depth, width, t]
        for h in np.linspace(min_h, max_h, n_shelves):
            boxes.append(([cx, cy, h], plate))
    else:
        boxes.append(([cx - width / 2, cy, cz], [t, depth, height]))
        boxes.append(([cx + width / 2, cy, cz], [t, depth, height]))
        plate = [width, depth, t]
        for h in np.linspace(min_h, max_h, n_shelves):
            boxes.append(([cx, cy, h], plate))
    return boxes


def hard_scenario(idx: int, capacity: int = 40, dtype: torch.dtype = torch.float64,
                  device=None) -> World:
    """The 7 curated hard scenes, 1-indexed like the reference."""
    if idx == 1:  # table
        start = [0, 0.5, 0, -0.5, 0, 0, 0]
        goal = [0, -0.5, 0, 0.5, 0, 0, 0]
        boxes = [([1.1, 0, 0.8], [1, 4, 0.01])]
    elif idx == 2:  # wall / doorway
        start = [PI / 2, 0.5, 0, 0, 0, 0, 0]
        goal = [-PI / 2, 0.5, 0, 0.5, 0, 0, 0]
        boxes = [([1.1, 0, 0.8], [1, 0.01, 4])]
    elif idx == 3:  # posts
        start = [PI / 2, PI / 4, 0, 0, 0, 0, 0]
        goal = [0.15, -0.75, 0.2, 0.4, 0.3, 0.2, 0]
        boxes = [
            ([0.8, -0.25, 2], [0.05, 0.05, 4]),
            ([0.4, 0.25, 2], [0.05, 0.05, 4]),
        ]
    elif idx == 4:  # shelves
        start = [0, -0.5, 0, 0.5, 0, 0, 0]
        goal = [-PI / 2, PI / 2, -PI / 2, 0.5, 0, 0, 0]
        boxes = _shelf([1.1, 0, 0.7], 1.4, 1.2, 0.8, 3, 0.3, 1.3, 1)
        boxes += _shelf([0, 1.1, 0.7], 1.4, 1.2, 0.8, 3, 0.3, 1.3, 2)
    elif idx == 5:  # inside box
        start = [0, 0, 0, -PI / 2, 0, 0, 0]
        goal = [0.15, 0.1, 0.2, 0.4, 0.3, 0.2, 0]
        L = [0.4, 0.4, 0.66]
        bc = [0.45, 0, L[2] / 2]
        boxes = [
            ([bc[0], bc[1] + L[1] / 2, bc[2]], [L[0], 0.01, L[2]]),
            ([bc[0] - L[0] / 2, bc[1], bc[2]], [0.01, L[1], L[2]]),
            ([bc[0], bc[1] - L[1] / 2, bc[2]], [L[0], 0.01, L[2]]),
            ([bc[0] + L[0] / 2, bc[1], bc[2]], [0.01, L[1], L[2]]),
        ]
    elif idx == 6:  # sink to cupboard
        start = [0, PI / 6, 0, -PI / 3 - 0.15, 0, -PI / 3, 0]
        goal = [PI / 6, 5 * PI / 12, -PI / 2, -PI / 8, PI / 2, -PI / 2, 0]
        cc = np.array([0.6, 0, 0.6])
        cl, cw, sw, sd = 0.5, 2.0, 0.5, 0.3
        cup = np.array([0.6, -0.55, 1.4])
        cul, cuw, cud = cl, 0.5, 0.5
        boxes = [
            (cc + [0, sw / 2 + cw / 2, 0], [cl, cw, 0.01]),
            (cc + [0, -sw / 2 - cw / 2, 0], [cl, cw, 0.01]),
            (cc + [0, sw / 2, -sd / 2], [sw, 0.01, sd]),
            (cc + [0, -sw / 2, -sd / 2], [sw, 0.01, sd]),
            (cc + [sw / 2, 0, -sd / 2], [0.01, sw, sd]),
            (cc + [-sw / 2, 0, -sd / 2], [0.01, sw, sd]),
            (cc + [0, 0, -sd], [sw, sw, 0.01]),
            (cup + [0, cuw / 2, 0], [cul, 0.01, cud]),
            (cup + [0, -cuw / 2, 0], [cul, 0.01, cud]),
            (cup + [0, 0, cud / 2], [cul, cuw, 0.01]),
            (cup + [0, 0, -cud / 2], [cul, cuw, 0.01]),
            (cup + [cul / 2, 0, 0], [0.01, cuw, cud]),
        ]
        boxes = [(list(c), list(s)) for c, s in boxes]
    elif idx == 7:  # reach through window
        start = [0, PI / 2, 0, -PI / 4, 0, 0, 0]
        goal = [0, 0, 0, 0, PI / 3, PI / 3, 0]
        wc = np.array([0.6, 0, 0.8])
        wsl, oh, ow = 0.625, 1.5, 1.5
        boxes = [
            (wc + [0, 0, -wsl / 2 - oh / 2], [0.01, 4, oh]),
            (wc + [0, 0, +wsl / 2 + oh / 2], [0.01, 4, oh]),
            (wc + [0, -wsl / 2 - ow / 2, 0], [0.01, ow, 4]),
            (wc + [0, +wsl / 2 + ow / 2, 0], [0.01, ow, 4]),
        ]
        boxes = [(list(c), list(s)) for c, s in boxes]
    else:
        raise ValueError(f"unknown scenario {idx}")

    boxes = _fetch_to_kinova(boxes)
    centers = np.asarray([b[0] for b in boxes])
    sides = np.asarray([b[1] for b in boxes])
    return _world(start, goal, centers, sides, capacity, dtype, device)


def stack_worlds(worlds, dtype: torch.dtype = torch.float64):
    """Pack a list of Worlds into batch tensors for run_batch/plan_batch:
    starts, goals (B, nf), zonos (B, cap, 4, 3), masks (B, cap)."""
    starts = torch.stack([w.start.to(dtype) for w in worlds])
    goals = torch.stack([w.goal.to(dtype) for w in worlds])
    zonos = torch.stack([w.obstacles.zonos.to(dtype) for w in worlds])
    masks = torch.stack([w.obstacles.mask for w in worlds])
    return starts, goals, zonos, masks
