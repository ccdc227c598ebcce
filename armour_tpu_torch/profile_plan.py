"""Where the time of one batched plan goes, on the card.

    python -m armour_tpu_torch.profile_plan [--batch 128] [--obstacles 8] [--seed 0]
    python -m armour_tpu_torch.profile_plan --batch 32 64 128 256 512
    python -m armour_tpu_torch.profile_plan --obstacles 8 40 --batch1 5 --tree DIR

Runs ``ArmourPlanner.plan_batch`` (float32, ``PlannerConfig()``; on the
card through its programs kept per (B, bucket), CUDA graphs) on the
problems of ``problems.problem_set`` and prints one JSON line per
``--batch`` and ``--obstacles`` with:

- ``first_call_s`` (the programs' captures included), ``seconds_per_batch``
  (the median of ``--reps`` replays), ``plans_per_s``,
  ``feasible_fraction``, ``build_s`` and ``solve_s`` (of one more replay,
  split by a device synchronise), ``capture_ms`` (the sum over the kept
  programs' graphs), ``graphs`` and the cache's ``programs`` statistics:
  host clock around work that ends in a device synchronise;
- ``device_busy_s`` and ``device_idle_share``: the summed device time of
  every kernel in one ``torch.profiler`` trace of ``plan_batch`` against
  that run's wall time (kernels of one stream do not overlap, so the sum
  is the busy time), with the number of kernel launches and the kernels
  that take the most device time;
- ``host_cumulative_s``: a ``cProfile`` run of ``plan_batch``, the
  cumulative host time of the planner's own functions (``cProfile`` adds
  cost to every Python call, so read these as shares, not as times).

``--batch1 N`` adds one line for ``plan`` (batch 1, the first world of each
``--obstacles`` set and N more of its bucket): the first call and the
median of the N replays, in ms.

``--tree DIR`` runs the package of another checkout instead of this one
(the parent commit unpacked into a git-ignored directory, say), so that two
versions run the same probe in one chip call, each in a process of its
own; a version without kept batched programs reports the eager build and
the solve instead of the split of a replay.

Needs a CUDA device; ``--device cpu`` rehearses the script at a small size
and reports no device figures.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

# the planner functions whose cumulative host time is reported
_HOST_FUNCS = ("run_program", "build_probs", "solve", "solve_box_alm_multi", "inner_step",
               "cj_multi", "diagonal_jacobian_t", "separable_cost_derivatives", "pv_fn", "f_fn",
               "slice_with_jac_multi", "collision_constraints_with_jac_multi",
               "fused_collision_value_jac_multi", "spd_solve_small")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def _capture_ms(planner) -> float:
    """The capture ms of every graph the planner's batched programs keep."""
    from armour_tpu_torch.utils.graphs import CapturedStep

    return sum(s.capture_ms for p in planner.batch_programs.entries.values() for s in p.steps
               if isinstance(s, CapturedStep))


def profile(planner, p, dev, reps: int) -> dict:
    """One JSON record for the batch of problems ``p``."""
    import torch

    kept = hasattr(planner, "batch_programs")
    run_args = (p.q0, p.qd0, p.qdd0, p.q_des, p.zonos, p.masks)
    first_s, _ = _timed(lambda: planner.plan_batch(*run_args), dev)
    out = {}
    if kept:
        out.update(capture_ms=_capture_ms(planner), programs=planner.batch_programs.stats())
    walls = []
    for _ in range(reps):
        wall, res = _timed(lambda: planner.plan_batch(*run_args), dev)
        walls.append(wall)
    if kept:
        marks = {}
        _sync(dev)
        t0 = time.perf_counter()
        _, prob = planner.run_program(*run_args, marks=marks)
        build_s, solve_s = marks["built"] - t0, marks["solved"] - marks["built"]
    else:
        build_s, prob = _timed(lambda: planner.build_probs(*run_args[:3], *run_args[4:]), dev)
        solve_s, _ = _timed(lambda: planner.solve(prob, p.q_des), dev)
    B = len(p.q0)
    sec = statistics.median(walls)
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "tree": _tree_root(), "batch": B, "obstacles": int(p.masks.sum(1).max()),
           "T": planner.cfg.num_time_steps, "bucket": int(prob.hp.dpos.shape[-2]),
           "first_call_s": first_s, "seconds_per_batch": sec, "seconds_runs": walls,
           "plans_per_s": B / sec, "feasible_fraction": float(res.feasible.float().mean()),
           "build_s": build_s, "solve_s": solve_s, "kept_batched_programs": kept, **out}
    if kept:
        out["graphs"] = out["programs"]["captures"]
    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out.update(_traces(planner, run_args, dev))
    if kept:
        planner.batch_programs.clear()
    return out


def _traces(planner, run_args, dev) -> dict:
    """The device time of one traced replay (on the card) and the host
    profile of another."""
    import torch

    out = {}
    if dev.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced_wall, _ = _timed(lambda: planner.plan_batch(*run_args), dev)
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.device_time for e in kernels)
        by_name: dict[str, list] = {}
        for e in kernels:
            agg = by_name.setdefault(e.name, [0, 0.0])
            agg[0] += 1
            agg[1] += e.device_time
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out.update({
            "traced_wall_s": traced_wall,
            "device_busy_s": busy_us * 1e-6,
            "device_idle_share": 1.0 - busy_us * 1e-6 / traced_wall,
            "kernel_launches": len(kernels),
            "top_kernels": [{"name": n[:90], "launches": c, "device_s": t * 1e-6} for n, (c, t) in top],
        })

    prof_host = cProfile.Profile()
    prof_host.enable()
    planner.plan_batch(*run_args)
    _sync(dev)
    prof_host.disable()
    cum: dict[str, float] = {}
    for (_, _, func), (_, _, _, ct, _) in pstats.Stats(prof_host).stats.items():
        if func in _HOST_FUNCS:
            cum[func] = cum.get(func, 0.0) + ct
    out["host_cumulative_s"] = {f: cum[f] for f in _HOST_FUNCS if f in cum}
    return out


def batch1(planner, p, dev, n_replays: int) -> dict:
    """``plan`` of the first world of ``p`` (its program's first call) and
    of ``n_replays`` more worlds of the same bucket (replays)."""
    from armour_tpu_torch.collision.zonotope import ObstacleSet
    from armour_tpu_torch.planner.armour import obstacle_bucket

    worlds = [(p.q0[i], p.qd0[i], p.qdd0[i], p.q_des[i], ObstacleSet(p.zonos[i], p.masks[i]))
              for i in range(n_replays + 1)]
    buckets = {obstacle_bucket(w[4].mask) for w in worlds}
    ms = [_timed(lambda w=w: planner.plan(*w), dev)[0] * 1e3 for w in worlds]
    stats = planner.programs.stats()
    planner.programs.clear()
    return {"tree": _tree_root(), "path": "plan", "obstacles": int(p.masks[0].sum()),
            "buckets": sorted(buckets), "first_call_ms": ms[0], "replay_ms": ms[1:],
            "replay_median_ms": statistics.median(ms[1:]), "programs": stats}


def _tree_root() -> str:
    from armour_tpu_torch.collision import kernels

    return os.path.abspath(os.path.join(os.path.dirname(kernels.__file__), "..", ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128])
    ap.add_argument("--obstacles", type=int, nargs="+", default=[8])
    ap.add_argument("--seed", type=int, nargs="+", default=None,
                    help="one seed per --obstacles (default 0 for 8, 7 otherwise)")
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch1", type=int, default=0, metavar="N",
                    help="also time plan(): a first call and N replays")
    ap.add_argument("--tree", default=None, help="checkout whose armour_tpu_torch to run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tree:
        # import the package afresh from the other checkout
        sys.path.insert(0, os.path.abspath(args.tree))
        for name in [m for m in sys.modules if m.split(".")[0] == "armour_tpu_torch"]:
            del sys.modules[name]
    import torch

    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.problems import problem_set
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec

    if args.tree:
        assert _tree_root() == os.path.abspath(args.tree), _tree_root()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_plan: no CUDA device is available")
    cfg = PlannerConfig(num_time_steps=args.time_steps)
    planner = ArmourPlanner(kinova_gen3_spec(), cfg, dtype=torch.float32, device=dev)
    seeds = args.seed or [0 if n == 8 else 7 for n in args.obstacles]
    for n_obs, seed in zip(args.obstacles, seeds):
        for B in args.batch:
            p = problem_set(cfg, B, n_obs=n_obs, seed=seed, device=dev)
            print(json.dumps(profile(planner, p, dev, args.reps)), flush=True)
        if args.batch1:
            p = problem_set(cfg, args.batch1 + 1, n_obs=n_obs, seed=seed, device=dev)
            print(json.dumps(batch1(planner, p, dev, args.batch1)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
