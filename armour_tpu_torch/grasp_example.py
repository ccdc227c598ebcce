"""Waiter-task / grasp-constraint demo (a rebuild of `grasp_simple.m`)
through the port.

    python -m armour_tpu_torch.grasp_example [--f64] [--out wrench.png]
    python -m armour_tpu_torch.grasp_example --device cpu

Counterpart of `examples/grasp_example.py`.  The arm carries an object on
a tray-like end-effector surface.  The planner adds the contact trio to
the NLP (separation, friction cone with u_s = 0.6, and tipping/ZMP with
surf_rad = 0.029 m, `grasp_simple.m:23-30`), built as polynomial zonotopes
over k from the end-effector acceleration reachable sets, so any realized
trajectory within tracking error keeps the object held.  The example plans
once with the contact constraints (which must be feasible), prints the
tray tilt along the plan, plans the same motion without them, and draws
the contact-wrench figure to ``--out`` where matplotlib is installed.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import GraspConfig, PlannerConfig
from armour_tpu_torch.device import resolve_device, to_numpy
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.jrs.bezier import bezier_ref
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.utils.plotting import plot_grasp_wrench


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--time-steps", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "armour_tpu_torch_grasp_wrench.png"),
                    help="where the contact-wrench figure goes")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=args.time_steps, max_obstacles=8)
    grasp = GraspConfig(object_mass=0.5, u_s=0.6, surf_rad=0.029)
    planner = ArmourPlanner(spec, cfg, dtype, device=device, grasp=grasp)

    # tray-up start pose; a box obstacle to the side
    q0 = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])
    zero = np.zeros(7)
    obstacles = ObstacleSet.from_boxes(np.array([[0.5, 0.3, 0.4]]), np.array([[0.15, 0.15, 0.15]]),
                                       cfg.max_obstacles)
    goal = q0 + np.array([0.6, 0.2, -0.3, 0.4, 0.2, -0.2, 0.5]) * cfg.k_range

    res = planner.plan(q0, zero, zero, goal, obstacles)
    print(f"grasp-constrained plan: feasible={bool(res.feasible)} "
          f"max_violation={float(res.max_violation):.3e}")
    if not bool(res.feasible):
        raise SystemExit("expected a feasible grasp-constrained plan")

    # the tray tilt along the realized nominal trajectory
    k = to_numpy(res.k)
    tilts = []
    for sv in (0.0, 0.25, 0.5, 0.75, 1.0):
        q, _, _ = bezier_ref(q0, zero, zero, cfg.k_range * k, sv, cfg.duration)
        Rw, _ = forward_kinematics(spec, torch.as_tensor(q, dtype=dtype, device=device))
        tilts.append(float(np.degrees(np.arccos(np.clip(to_numpy(Rw)[-1][2, 2], -1, 1)))))
        print(f"  s={sv:.2f}: tray tilt {tilts[-1]:5.2f} deg")

    # the same motion WITHOUT the object-holding requirement
    free = ArmourPlanner(spec, cfg, dtype, device=device)
    res_free = free.plan(q0, zero, zero, goal, obstacles)
    print(f"unconstrained comparison: feasible={bool(res_free.feasible)}")

    # contact-wrench figure (the reference's force/ZMP figure families):
    # separation force, friction-cone ratio, ZMP point in the contact
    # circle along the realized nominal trajectory
    def q_fn(t):
        # bezier_ref takes WALL-CLOCK t (it normalizes by duration
        # internally): passing t/duration would double-normalize and
        # sample only the first 1/duration of the trajectory
        qt, _, _ = bezier_ref(q0, zero, zero, cfg.k_range * k, t, cfg.duration)
        return torch.as_tensor(qt, dtype=dtype, device=device)

    fig = plot_grasp_wrench(spec, grasp, q_fn, args.out, duration=cfg.duration, device=device)
    if fig:
        print(f"figure: {os.path.normpath(fig)}")
    return {"grasp_feasible": bool(res.feasible), "max_violation": float(res.max_violation),
            "tray_tilt_deg": tilts, "free_feasible": bool(res_free.feasible), "figure": fig}


if __name__ == "__main__":
    main()
