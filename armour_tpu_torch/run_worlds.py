"""Random-world battery (`kinova_run_100_worlds.m`) through the port.

    python -m armour_tpu_torch.run_worlds [--max-iterations 2] [--out r.json]
    python -m armour_tpu_torch.run_worlds --device cpu --f64 --time-steps 16 \\
        --max-worlds 2 --max-iterations 2

Runs batched receding-horizon episodes over a directory of
reference-format world CSVs (the suite in ``assets/worlds`` by default),
prints the safety/success table, and writes the JSON schema of
``scripts/run_100_worlds.py`` with ``--out``.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import torch

from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.harness import EpisodeRunner, EpisodeSummary, run_batch_stepped
from armour_tpu_torch.sim.scenarios import load_world_csv, stack_worlds
from armour_tpu_torch.utils.summary import format_summary, protocol_block, summarize_episodes

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "worlds")
FLAGS = EpisodeSummary._fields[:6]   # goal_reached ... stopped


def world_files(worlds_dir: str, max_worlds: int, names: str = "") -> list:
    """The sorted CSVs of a directory, optionally only the given basenames."""
    files = sorted(glob.glob(os.path.join(worlds_dir, "*.csv")))
    if names:
        want = set(names.split(","))
        files = [f for f in files if os.path.basename(f) in want]
        missing = want - {os.path.basename(f) for f in files}
        if missing:
            raise SystemExit(f"worlds not found: {sorted(missing)}")
    files = files[:max_worlds]
    if not files:
        raise SystemExit(f"no world CSVs in {worlds_dir}")
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds-dir", default=ASSETS)
    ap.add_argument("--max-worlds", type=int, default=100)
    ap.add_argument("--worlds", default="",
                    help="comma-separated CSV basenames to run (a subset, e.g. the stopped worlds)")
    ap.add_argument("--batch", type=int, default=0, help="worlds per batch (0 = all)")
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--max-iterations", type=int, default=500,
                    help="reference battery cap (kinova_run_100_worlds.m:64 max_sim_iter=500)")
    ap.add_argument("--traj-type", default="bernstein", choices=["bernstein", "orig"])
    ap.add_argument("--driver", default="stepped", choices=["stepped", "scan"],
                    help="stepped = the battery driver; scan = the episode program")
    ap.add_argument("--f64", action="store_true", help="run in float64")
    ap.add_argument("--collision-oracle", default="mesh", choices=["mesh", "box"],
                    help="ground-truth collision check: exact link-mesh oracle or the "
                         "conservative bounding boxes (stepped driver only)")
    ap.add_argument("--hlp", default="straight", choices=["straight", "rrt_connect", "ee_rrt_star"],
                    help="initial waypoint family of the stepped driver (stalled worlds escalate "
                         "regardless)")
    ap.add_argument("--stop-rescue", type=int, default=0,
                    help="SimConfig.stop_rescue_attempts (0 = the reference stop protocol)")
    ap.add_argument("--out", default="", help="write the JSON summary here")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dtype = torch.float64 if args.f64 else torch.float32
    spec = kinova_gen3_spec()
    pcfg = PlannerConfig(num_time_steps=args.time_steps)
    scfg = SimConfig(max_iterations=args.max_iterations, stop_rescue_attempts=args.stop_rescue)
    runner = EpisodeRunner(spec, pcfg, scfg, dtype, device=args.device, traj_type=args.traj_type)
    files = world_files(args.worlds_dir, args.max_worlds, args.worlds)
    worlds = [load_world_csv(f, pcfg.max_obstacles, dtype, device=runner.device) for f in files]
    print(f"loaded {len(worlds)} worlds from {args.worlds_dir}")
    starts, goals, zonos, masks = stack_worlds(worlds, dtype)
    gen = torch.Generator(device=runner.device).manual_seed(0)

    B = args.batch or len(worlds)
    outs = []
    t0 = time.perf_counter()
    for i in range(0, len(worlds), B):
        sl = slice(i, min(i + B, len(worlds)))
        if args.driver == "stepped":
            s = run_batch_stepped(runner, starts[sl], goals[sl], zonos[sl], masks[sl], gen,
                                  verbose=True, collision_oracle=args.collision_oracle,
                                  hlp=args.hlp)
        else:
            s = runner.run_batch(starts[sl], goals[sl], zonos[sl], masks[sl], gen)
        outs.append(s)
        print(f"  batch {i // B}: {int(s.goal_reached.sum())} goals reached")
    wall = time.perf_counter() - t0

    merged = EpisodeSummary(*(None if xs[0] is None else torch.cat([x.cpu() for x in xs])
                              for xs in zip(*outs)))
    d = summarize_episodes(merged, protocol=protocol_block(pcfg, scfg, args.hlp, dtype))
    d["traj_type"] = args.traj_type
    d["max_iterations"] = args.max_iterations
    d["wall_seconds"] = round(wall, 2)
    d["episodes_per_minute"] = round(len(worlds) / wall * 60, 2)
    d["device"] = str(runner.device) if runner.device.type != "cuda" else \
        torch.cuda.get_device_name(runner.device)
    # per-world rows, so that each outcome is diagnosable from the artifact
    margins = {k: getattr(merged, k).numpy() for k in ("jl_overshoot", "ub_overshoot",
                                                        "torque_overshoot")
               if getattr(merged, k) is not None}
    d["worlds"] = [
        dict(world=os.path.basename(files[i]),
             iterations=int(merged.iterations[i]),
             n_feasible_plans=int(merged.n_feasible_plans[i]),
             **{k: bool(getattr(merged, k)[i]) for k in FLAGS},
             **{k: round(float(v[i]), 6) for k, v in margins.items()})
        for i in range(len(worlds))
    ]
    print(format_summary(d))
    print(f"wall: {wall:.1f}s ({d['episodes_per_minute']} episodes/min)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(d, f, indent=2)
    return d


if __name__ == "__main__":
    main()
