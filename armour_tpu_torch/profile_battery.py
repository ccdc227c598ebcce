"""Per-iteration wall split of the 100-world battery.

    python -m armour_tpu_torch.profile_battery [--iterations 3] [--tree DIR]
    python -m armour_tpu_torch.profile_battery --device cpu --iterations 1 \\
        --max-worlds 1 --time-steps 16 --collision-oracle box
    python -m armour_tpu_torch.profile_battery --episode 128 [--iterations 8] [--calls 2] [--tree DIR]

Runs the battery driver (``run_batch_stepped``) over the worlds of
`assets/worlds` (all of them in one batch; T=128, f32, straight HLP, mesh
oracle by default) for a few iterations and prints one JSON line: each
iteration's build, solve, roll-and-check and wall seconds (timed to a device
synchronise), the total seconds and the peak allocated card memory; and, per
iteration (``programs``), the graphs the planner's kept programs captured,
their cache hits and misses, those of the driver's kept stages
(``stage_*``) and the card's allocated memory after the iteration (captures
are iteration 0's and a new bucket's; the rest replay).

``--episode B`` times ``EpisodeRunner.run_batch`` instead, on B worlds of the
8-obstacle problem set (seed 0) with goals 0.3-0.6 rad from each start in
every joint, for ``--iterations``: the host clock and the allocated memory
at each iteration's draw (``iteration_s``: from one draw to the next, the
last to the end of the run after a synchronise; a kept loop on the card runs
one iteration ahead, so the spacing is an iteration's wall once it runs
steadily) and the kept programs' counts; ``--calls N`` runs the episode N
times in the process (each call captures its programs anew; the first also
pays the process's one-time costs).

``--tree DIR`` runs the package of another checkout instead of this one (for
example the parent commit unpacked into a git-ignored directory), so that
two versions run the same probe in one chip call, each in a process of its
own.  Runs on the card unless ``--device cpu`` is given.

``--profile-from N`` profiles the host (cProfile) from iteration N to the
end: a late slice of a run, where the stalled worlds' guidance runs.  The
line then holds each iteration's whole split (the iterations before N run
unprofiled) and ``host_profile``: the cumulative seconds of the host
guidance phases inside the profiled slice (RRT-connect, RRT*, EE RRT*, IK,
the clearance waypoints, the mesh oracle, and the battery's workspace-path
waypoints whole, ``ee_waypoints``: where the IK is a kept program, ``ik``
counts only its op-by-op runs); the build, the solve and the move are in
each iteration's split.
"""

from __future__ import annotations

import argparse
import cProfile
import glob
import json
import os
import pstats
import sys
import time

SPLIT = ("ref_waypoints_s", "build_probs_s", "solve_s", "roll_and_check_s", "mesh_refine_s",
         "host_s", "wall_s")
PROGRAMS = ("program_captures", "program_hits", "program_misses", "stage_captures", "stage_hits",
            "stage_misses", "stage_evictions", "stage_hits_by_name", "memory_allocated",
            "bucket_culled", "ee_worlds", "mesh_flagged")
# the host phases of a battery iteration: (module file, function) -> name.
# The build, the solve and the move are the trace's split: on the card
# cProfile recorded no entry for the planner's solve or the ALM loop (their
# callees it did), so it is not asked for them
PHASES = {
    ("hlp.py", "rrt_connect_waypoints"): "rrt_connect",
    ("hlp.py", "rrt_star_waypoints"): "rrt_star",
    ("hlp.py", "ee_rrt_star_waypoints"): "ee_rrt_star",
    ("hlp.py", "ee_rrt_star_config_waypoints"): "ee_rrt_star_config",
    ("hlp.py", "ik_to_position"): "ik",
    ("hlp.py", "clearance_waypoint"): "clearance_waypoint",
    ("mesh_oracle.py", "check"): "mesh_oracle",
    # the battery driver's workspace-path waypoints: the EE positions, the
    # host lookahead and the IK, kept or not
    ("harness.py", "_ee_waypoints"): "ee_waypoints",
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--max-worlds", type=int, default=100)
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--collision-oracle", default="mesh", choices=["mesh", "box"])
    ap.add_argument("--tree", default=None, help="checkout whose armour_tpu_torch to run")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--profile-from", type=int, default=None, metavar="N",
                    help="profile the host from iteration N to the end")
    ap.add_argument("--episode", type=int, default=None, metavar="B",
                    help="time run_batch on B worlds of the 8-obstacle problem set instead")
    ap.add_argument("--calls", type=int, default=1, help="run_batch calls with --episode")
    args = ap.parse_args(argv)

    if args.tree:
        # import the package afresh from the other checkout
        tree = os.path.abspath(args.tree)
        sys.path.insert(0, tree)
        for name in [m for m in sys.modules if m.split(".")[0] == "armour_tpu_torch"]:
            del sys.modules[name]
    import torch

    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.config import PlannerConfig, SimConfig
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim.harness import EpisodeRunner, run_batch_stepped
    from armour_tpu_torch.sim.scenarios import load_world_csv, stack_worlds

    root = os.path.abspath(os.path.join(os.path.dirname(kernels.__file__), "..", ".."))
    if args.tree:
        assert root == tree, (root, tree)
    f32 = torch.float32
    cfg = PlannerConfig(num_time_steps=args.time_steps)
    runner = EpisodeRunner(kinova_gen3_spec(), cfg, SimConfig(max_iterations=args.iterations), f32,
                           device=args.device)
    dev = runner.device
    files = sorted(glob.glob(os.path.join(root, "assets", "worlds", "*.csv")))[:args.max_worlds]
    worlds = [load_world_csv(f, cfg.max_obstacles, f32, device=dev) for f in files]
    starts, goals, zonos, masks = stack_worlds(worlds, f32)
    gen = torch.Generator(device=dev).manual_seed(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if args.episode is not None:
        return _episode(args, runner, root, gen, sync)
    trace = []
    prof = cProfile.Profile() if args.profile_from is not None else None

    def progress(it, _summary):
        if it + 1 == args.profile_from:
            prof.enable()

    sync()
    t0 = time.perf_counter()
    if prof is not None and args.profile_from == 0:
        prof.enable()
    run_batch_stepped(runner, starts, goals, zonos, masks, gen,
                      collision_oracle=args.collision_oracle, hlp="straight", trace=trace,
                      progress=progress if prof is not None else None)
    sync()
    seconds = time.perf_counter() - t0
    out = {"tree": root, "worlds": len(files), "seconds": seconds,
           "max_allocated_gib": torch.cuda.max_memory_allocated() / 2**30
           if dev.type == "cuda" else None,
           "iterations": [{k: tr[k] for k in (*SPLIT, "active")} for tr in trace],
           # absent in a version without kept batched programs
           "programs": [{k: tr.get(k) for k in PROGRAMS} for tr in trace]}
    if prof is not None:
        prof.disable()
        stats = pstats.Stats(prof).stats     # (file, line, name) -> (cc, nc, tt, ct, callers)
        phases = dict.fromkeys(PHASES.values(), 0.0)
        for (path, _, name), (_, _, _, ct, _) in stats.items():
            key = PHASES.get((os.path.basename(path), name))
            if key:
                phases[key] += ct
        late = trace[args.profile_from:]
        out["host_profile"] = {"from": args.profile_from, "iterations": len(late),
                               "wall_s": sum(tr["wall_s"] for tr in late),
                               "phase_s": phases}
    print(json.dumps(out), flush=True)
    return out


def _episode(args, runner, root, gen, sync) -> dict:
    import numpy as np
    import torch

    from armour_tpu_torch.problems import problem_set
    from armour_tpu_torch.sim.harness import generator_draws

    cfg, dev, B = runner.plan_cfg, runner.device, args.episode
    p = problem_set(cfg, B, n_obs=8, seed=0, device=dev)
    goals = p.q0 + 0.3 * np.sign(p.q_des - p.q0) + 0.3 * (p.q_des - p.q0) / cfg.k_range
    programs = getattr(runner, "programs", None)      # absent before the kept episode program
    calls = []
    for _ in range(args.calls):
        inner = generator_draws(runner.planner, runner.sim_cfg, B, gen)
        stamps, memory = [], []

        def draws(i, inner=inner, stamps=stamps, memory=memory):
            stamps.append(time.perf_counter())
            memory.append(torch.cuda.memory_allocated() if dev.type == "cuda" else None)
            return inner(i)

        sync()
        t0 = time.perf_counter()
        s = runner.run_batch(p.q0, goals, p.zonos, p.masks, gen, draws=draws)
        sync()
        end = time.perf_counter()
        calls.append({"seconds": end - t0, "iteration_s": np.diff(stamps + [end]).tolist(),
                      "memory_allocated": memory, "iterations_max": int(s.iterations.max()),
                      "n_feasible_plans": int(s.n_feasible_plans.sum())})
    out = {"tree": root, "episode_worlds": B, "calls": calls,
           "max_allocated_gib": torch.cuda.max_memory_allocated() / 2**30
           if dev.type == "cuda" else None,
           "episode_programs": programs.stats() if programs is not None else None,
           "plan_programs": runner.planner.batch_programs.stats()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
