"""Seeded random planning problems for the batched planner.

Port of the JAX benchmark's problem set (`bench.py:25-76`, `_problem_set`):
the same numpy random stream and the same rejection screen, so one seed
gives the same worlds in both packages.  Obstacles are rejection-sampled
clear of the arm's start volume (otherwise many problems are infeasible
at t = 0); the screen runs on ``device`` in float32, as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.world import arm_collision_check

Q_HOME = (0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0)


class Problems(NamedTuple):
    """B planning problems as float64 numpy arrays."""

    q0: np.ndarray      # (B, 7)
    qd0: np.ndarray
    qdd0: np.ndarray
    q_des: np.ndarray
    zonos: np.ndarray   # (B, cfg.max_obstacles, 4, 3)
    masks: np.ndarray   # (B, cfg.max_obstacles) bool


def problem_set(cfg: PlannerConfig, B: int, n_obs: int = 8, seed: int = 0,
                device=None, q_center=Q_HOME) -> Problems:
    """``n_obs``: LIVE obstacles per world (8 = the benchmark default;
    40 = the reference's worst-case capacity, Parameters.h:26-29).  The
    start poses are ``q_center`` plus a uniform +-0.3 rad per joint."""
    dev = resolve_device(device)
    spec = kinova_gen3_spec()
    rng = np.random.default_rng(seed)
    q0 = np.tile(q_center, (B, 1))
    q0 += rng.uniform(-0.3, 0.3, (B, 7))
    qd0 = rng.uniform(-0.2, 0.2, (B, 7))
    qdd0 = rng.uniform(-0.3, 0.3, (B, 7))
    q_des = q0 + rng.uniform(-1.0, 1.0, (B, 7)) * cfg.k_range
    n_cand = max(64, 4 * n_obs)
    c_all = rng.uniform(-0.85, 0.85, (B, n_cand, 3))
    c_all[..., 2] = np.abs(c_all[..., 2]) + 0.1
    s_all = rng.uniform(0.05, 0.3, (B, n_cand, 3))
    cand_zonos = np.zeros((B, n_cand, 1, 4, 3), np.float32)
    cand_zonos[:, :, 0, 0, :] = c_all
    for i in range(3):
        cand_zonos[:, :, 0, 1 + i, i] = (s_all[..., i] + 0.1) * 0.5

    # all (world, candidate) screens in one batched call
    q = torch.as_tensor(q0, dtype=torch.float32, device=dev)[:, None].expand(B, n_cand, 7)
    cand = ObstacleSet(torch.as_tensor(cand_zonos, device=dev),
                       torch.ones((B, n_cand, 1), dtype=torch.bool, device=dev))
    hits = arm_collision_check(spec, q, cand).cpu().numpy()

    zonos = np.zeros((B, cfg.max_obstacles, 4, 3))
    masks = np.zeros((B, cfg.max_obstacles), bool)
    for b in range(B):
        keep = np.nonzero(~hits[b])[0][:n_obs]
        zonos[b, : keep.size, 0] = c_all[b, keep]
        for i in range(3):
            zonos[b, : keep.size, 1 + i, i] = s_all[b, keep, i] * 0.5
        masks[b, : keep.size] = True
    return Problems(q0, qd0, qdd0, q_des, zonos, masks)
