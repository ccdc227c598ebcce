"""Minimum end-to-end slice (a rebuild of `kinova_simple_example.m`) through
the port: a Kinova Gen3 in a small world with two box obstacles plans and
executes a receding-horizon motion to a configuration goal, with full
logging and figures.

    python -m armour_tpu_torch.simple_example [--f64] [--time-steps 64]
    python -m armour_tpu_torch.simple_example --device cpu --time-steps 16 --max-iterations 1

Counterpart of `examples/simple_example.py`: the same world, start and goal,
``run_recorded_episode`` at T = 64 for up to 30 iterations; it writes the
episode's ``.npz``, the hardware-playback CSV and, where matplotlib is
installed, the tracking, torque, top-down world and FRS figures into
``--out-dir`` (the temp directory unless given).  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.recording import load_recording, run_recorded_episode
from armour_tpu_torch.sim.world import World
from armour_tpu_torch.utils.plotting import (
    plot_frs_topdown,
    plot_torques,
    plot_tracking,
    plot_world_topdown,
)

START = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
GOAL = START + np.array([0.3, 0.15, -0.2, 0.25, -0.15, 0.1, 0.2])


def demo_world(cfg: PlannerConfig, dtype: torch.dtype, device) -> World:
    """The two-obstacle demo world in front of the arm."""
    obstacles = ObstacleSet.from_boxes(np.array([[0.4, 0.3, 0.5], [0.45, -0.2, 0.6]]),
                                       np.array([[0.12, 0.12, 0.12], [0.1, 0.1, 0.2]]),
                                       cfg.max_obstacles)
    return World(start=torch.as_tensor(START, dtype=dtype, device=device),
                 goal=torch.as_tensor(GOAL, dtype=dtype, device=device), obstacles=obstacles)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--time-steps", type=int, default=64)
    ap.add_argument("--max-iterations", type=int, default=30)
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "armour_tpu_torch_example"))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    spec = kinova_gen3_spec()
    pcfg = PlannerConfig(num_time_steps=args.time_steps)
    scfg = SimConfig(max_iterations=args.max_iterations)
    world = demo_world(pcfg, dtype, device)

    print("running recorded episode ...")
    t0 = time.perf_counter()
    rec = run_recorded_episode(spec, pcfg, scfg, world, dtype=dtype, verbose=True, device=device)
    seconds = time.perf_counter() - t0
    n_it = len(rec.records)
    print(f"goal_reached={rec.goal_reached} collision={rec.collision} "
          f"stopped={rec.stopped} iterations={n_it}")

    os.makedirs(args.out_dir, exist_ok=True)
    npz = os.path.join(args.out_dir, "episode.npz")
    csv = os.path.join(args.out_dir, "trajectory.csv")
    rec.save(npz)
    rec.export_hardware_csv(csv)
    loaded = load_recording(npz)
    figures = {
        "tracking": plot_tracking(loaded, spec, os.path.join(args.out_dir, "tracking.png")),
        "torques": plot_torques(loaded, spec, os.path.join(args.out_dir, "torques.png")),
        "world": plot_world_topdown(loaded, spec, os.path.join(args.out_dir, "world.png"),
                                    device=device),
        "frs": plot_frs_topdown(loaded, spec, os.path.join(args.out_dir, "frs.png"), iteration=0,
                                cfg=pcfg, dtype=dtype, device=device),
    }
    for out in figures.values():
        if out:
            print("wrote", out)
    return {"goal_reached": rec.goal_reached, "collision": rec.collision, "stopped": rec.stopped,
            "iterations": n_it, "n_feasible_plans": sum(r.feasible for r in rec.records),
            "seconds": seconds, "seconds_per_iteration": seconds / max(n_it, 1),
            "npz": npz, "csv": csv, "figures": figures}


if __name__ == "__main__":
    main()
