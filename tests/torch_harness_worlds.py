"""The battery driver's two test worlds, built without JAX: shared by the
CPU parity tests (`test_torch_harness.py` and the files that import it) and
the card test `test_torch_mesh_fk_cuda.py`.

World 0 is the first assets world cut to 7 obstacles (bucket 8); world 1
holds a 1 cm box inside a link's bounding box at its start, so the box
screen flags every window and the mesh oracle clears it.
"""

import glob
import os

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.scenarios import load_world_csv

SPEC = kinova_gen3_spec()
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "worlds")


def two_worlds():
    """numpy (starts, goals, zonos (2, 40, 4, 3), masks) of the two worlds."""
    w0 = load_world_csv(sorted(glob.glob(os.path.join(ASSETS, "*.csv")))[0], 40, device="cpu")
    z0, m0 = w0.obstacles.zonos.numpy().copy(), w0.obstacles.mask.numpy().copy()
    z0[7:], m0[7:] = 0.0, False
    start1 = np.array([0.3, 0.4, 0.0, -1.2, 0.0, 0.5, 0.0])
    Rw, pw = forward_kinematics(SPEC, torch.as_tensor(start1))
    link = 3
    center = (Rw[link] @ torch.as_tensor(SPEC.link_zono_center[link]) + pw[link]).numpy()
    assert np.all(np.asarray(SPEC.link_zono_gen[link]) > 0.02)
    obs1 = ObstacleSet.from_boxes(center[None], [[0.01, 0.01, 0.01]], 40)
    starts = np.stack([w0.start.numpy(), start1])
    goals = np.stack([w0.goal.numpy(), start1 + 0.8])
    return starts, goals, np.stack([z0, obs1.zonos]), np.stack([m0, obs1.mask])
