"""The traffic generator: planning problems and the solver's random starts,
made from the seed.

``worlds`` is a frozen copy of the numpy stream and rejection screen of
``armour_tpu_torch/problems.py::problem_set`` (itself `bench.py`'s
``_problem_set``): one seed gives the same worlds as there.  Start poses
are the Kinova's home pose plus a uniform +-0.3 rad per joint; obstacles
are boxes rejection-sampled clear of the arm at its start (the screen runs
in float32 on ``device``, as the original's).  ``starts`` draws the
``S - 2`` random interior starts of each world, uniform in [-0.6, 0.6)
like ``ArmourPlanner.random_starts``, from a stream of its own.

Both are inputs: the harness hands the same arrays to the program and to
the reference.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from armour_bench.reference.kinova import kinova_gen3_spec
from armour_bench.reference.world import arm_collision_check
from armour_bench.reference.zonotope import ObstacleSet

Q_HOME = (0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0)

FIELDS = ("q0", "qd0", "qdd0", "q_des", "zonos", "masks")


def seed_words(seed: int) -> list:
    """A numpy seed sequence's entropy for any whole number (negative
    numbers and numbers past 64 bits included)."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF]
    seed >>= 32
    while seed not in (0, -1):
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
    return words + ([1] if seed == -1 else [])


def worlds(n_worlds: int, n_obs: int, k_range: float, capacity: int, seed: int,
           device) -> dict:
    """``n_worlds`` problems of ``n_obs`` live obstacles in ``capacity``
    slots: float64 numpy arrays q0, qd0, qdd0, q_des (N, 7), zonos
    (N, capacity, 4, 3) and bool masks (N, capacity).  A world keeps fewer
    than ``n_obs`` obstacles only where fewer candidates clear the arm."""
    spec = kinova_gen3_spec()
    words = seed_words(seed)
    rng = np.random.default_rng(words if len(words) > 1 else words[0])
    B = n_worlds
    q0 = np.tile(Q_HOME, (B, 1))
    q0 += rng.uniform(-0.3, 0.3, (B, 7))
    qd0 = rng.uniform(-0.2, 0.2, (B, 7))
    qdd0 = rng.uniform(-0.3, 0.3, (B, 7))
    q_des = q0 + rng.uniform(-1.0, 1.0, (B, 7)) * k_range
    n_cand = max(64, 4 * n_obs)
    c_all = rng.uniform(-0.85, 0.85, (B, n_cand, 3))
    c_all[..., 2] = np.abs(c_all[..., 2]) + 0.1
    s_all = rng.uniform(0.05, 0.3, (B, n_cand, 3))
    cand_zonos = np.zeros((B, n_cand, 1, 4, 3), np.float32)
    cand_zonos[:, :, 0, 0, :] = c_all
    for i in range(3):
        cand_zonos[:, :, 0, 1 + i, i] = (s_all[..., i] + 0.1) * 0.5

    q = torch.as_tensor(q0, dtype=torch.float32, device=device)[:, None].expand(B, n_cand, 7)
    cand = ObstacleSet(torch.as_tensor(cand_zonos, device=device),
                       torch.ones((B, n_cand, 1), dtype=torch.bool, device=device))
    hits = arm_collision_check(spec, q, cand).cpu().numpy()

    zonos = np.zeros((B, capacity, 4, 3))
    masks = np.zeros((B, capacity), bool)
    for b in range(B):
        keep = np.nonzero(~hits[b])[0][:n_obs]
        zonos[b, : keep.size, 0] = c_all[b, keep]
        for i in range(3):
            zonos[b, : keep.size, 1 + i, i] = s_all[b, keep, i] * 0.5
        masks[b, : keep.size] = True
    return {"q0": q0, "qd0": qd0, "qdd0": qdd0, "q_des": q_des, "zonos": zonos, "masks": masks}


def starts(n_worlds: int, n_rand: int, n: int, seed: int) -> np.ndarray:
    """(N, n_rand, n) random interior starts in [-0.6, 0.6), float64."""
    rng = np.random.default_rng([*seed_words(seed), 0x5EED])
    return rng.uniform(0.0, 1.0, (n_worlds, n_rand, n)) * 1.2 - 0.6
