"""Hard-scenario battery (`kinova_run_hard_scenarios.m`) through the port:
the 7 curated scenes (table, doorway, posts, shelves, inside box,
sink-to-cupboard, window).

    python -m armour_tpu_torch.run_hard_scenarios [--scenarios 2] [--out r.json]

Writes the JSON schema of ``scripts/run_hard_scenarios.py`` with
``--out``.  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.harness import EpisodeRunner, EpisodeSummary, run_batch_stepped
from armour_tpu_torch.sim.scenarios import hard_scenario, stack_worlds

NAMES = {1: "table", 2: "doorway", 3: "posts", 4: "shelves",
         5: "inside box", 6: "sink->cupboard", 7: "window"}
FLAGS = EpisodeSummary._fields[:6]   # goal_reached ... stopped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenarios", type=int, nargs="*", default=list(range(1, 8)))
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--max-iterations", type=int, default=600,
                    help="reference hard-scene cap (kinova_run_hard_scenarios.m:65 max_sim_iter=600)")
    ap.add_argument("--hlp", default="rrt_connect", choices=["rrt_connect", "ee_rrt_star", "straight"],
                    help="configuration-space RRT-connect guidance (default) routes the WHOLE ARM "
                         "through narrow passages")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", default="", help="write the JSON summary here")
    ap.add_argument("--progress-every", type=int, default=0,
                    help="also write --out every N iterations, marked complete=false (0 = only "
                         "at the end)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dtype = torch.float64 if args.f64 else torch.float32
    spec = kinova_gen3_spec()
    pcfg = PlannerConfig(num_time_steps=args.time_steps)
    # hard scenes use a tighter goal radius (get_kinova_scenario_info.m: 0.05)
    scfg = SimConfig(max_iterations=args.max_iterations, goal_radius=0.05)
    runner = EpisodeRunner(spec, pcfg, scfg, dtype, device=args.device)
    worlds = [hard_scenario(i, pcfg.max_obstacles, dtype, device=runner.device)
              for i in args.scenarios]
    starts, goals, zonos, masks = stack_worlds(worlds, dtype)
    gen = torch.Generator(device=runner.device).manual_seed(0)

    def record(s):
        return [{"scenario": idx, "name": NAMES[idx],
                 **{k: bool(getattr(s, k)[j]) for k in FLAGS},
                 "iterations": int(s.iterations[j]), "n_feasible_plans": int(s.n_feasible_plans[j])}
                for j, idx in enumerate(args.scenarios)]

    def progress(it, s):
        if args.out and args.progress_every and (it + 1) % args.progress_every == 0:
            with open(args.out, "w") as f:
                json.dump({"collision_oracle": "mesh", "rows": record(s), "complete": False,
                           "iterations_run": it + 1}, f, indent=2)

    s = run_batch_stepped(runner, starts, goals, zonos, masks, gen, verbose=True, hlp=args.hlp,
                          progress=progress)
    rows = record(s)
    for row in rows:
        marks = [m for m, k in (("GOAL", "goal_reached"), ("COLLISION", "collision"),
                                ("stopped", "stopped")) if row[k]]
        print(f"scenario {row['scenario']} ({row['name']:>14}): {' '.join(marks) or 'incomplete'}  "
              f"iters={row['iterations']} plans={row['n_feasible_plans']}")
    out = {"collision_oracle": "mesh", "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
