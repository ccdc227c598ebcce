"""Where the time of one batched plan goes, on the card.

    python -m armour_tpu_torch.profile_plan [--batch 128] [--obstacles 8] [--seed 0]
    python -m armour_tpu_torch.profile_plan --batch 32 64 128 256 512

Runs ``ArmourPlanner.plan_batch`` (float32, ``PlannerConfig()``; on the
card its Gauss-Newton iteration is a CUDA graph) on the problems of
``problems.problem_set`` and prints one JSON line per ``--batch`` with:

- ``seconds_per_batch`` (median of ``--reps`` after a warm-up),
  ``plans_per_s``, ``feasible_fraction``, ``build_s``, ``solve_s`` and the
  solver graph's ``capture_ms``: host clock around work that ends in a
  device synchronise;
- ``device_busy_s`` and ``device_idle_share``: the summed device time of
  every kernel in one ``torch.profiler`` trace of ``plan_batch`` against
  that run's wall time (kernels of one stream do not overlap, so the sum
  is the busy time), with the number of kernel launches and the kernels
  that take the most device time;
- ``host_cumulative_s``: a ``cProfile`` run of ``plan_batch``, the
  cumulative host time of the planner's own functions (``cProfile`` adds
  cost to every Python call, so read these as shares, not as times).

Needs a CUDA device; ``--device cpu`` rehearses the script at a small size
and reports no device figures.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import time

import torch

from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.problems import problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.utils.graphs import CapturedStep

# the planner functions whose cumulative host time is reported
_HOST_FUNCS = ("build_probs", "solve", "solve_box_alm_multi", "inner_step", "cj_multi",
               "diagonal_jacobian_t", "separable_cost_derivatives", "pv_fn", "f_fn",
               "slice_with_jac_multi", "collision_constraints_with_jac_multi",
               "fused_collision_value_jac_multi", "spd_solve_small")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def profile(planner, p, dev, reps: int) -> dict:
    """One JSON record for the batch of problems ``p``."""
    run_args = (p.q0, p.qd0, p.qdd0, p.q_des, p.zonos, p.masks)
    planner.plan_batch(*run_args)                                  # warm-up
    walls = []
    for _ in range(reps):
        wall, res = _timed(lambda: planner.plan_batch(*run_args), dev)
        walls.append(wall)
    build_s, prob = _timed(lambda: planner.build_probs(p.q0, p.qd0, p.qdd0, p.zonos, p.masks), dev)
    solve_s, _ = _timed(lambda: planner.solve(prob, p.q_des), dev)
    B = len(p.q0)
    sec = statistics.median(walls)
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "batch": B, "obstacles": int(p.masks.sum(1).max()), "T": planner.cfg.num_time_steps,
           "bucket": int(prob.hp.dpos.shape[-2]), "seconds_per_batch": sec, "seconds_runs": walls,
           "plans_per_s": B / sec, "feasible_fraction": float(res.feasible.float().mean()),
           "build_s": build_s, "solve_s": solve_s, "capture_ms": CapturedStep.last_capture_ms}

    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128])
    ap.add_argument("--obstacles", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_plan: no CUDA device is available")
    cfg = PlannerConfig(num_time_steps=args.time_steps)
    planner = ArmourPlanner(kinova_gen3_spec(), cfg, dtype=torch.float32, device=dev)
    for B in args.batch:
        p = problem_set(cfg, B, n_obs=args.obstacles, seed=args.seed, device=dev)
        print(json.dumps(profile(planner, p, dev, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
