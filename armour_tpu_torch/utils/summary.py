"""Benchmark summary aggregation (cf. `kinova_test_summary.m:34-66`).

Port of `armour_tpu/utils/summary.py`; plain Python over host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from armour_tpu_torch.device import to_numpy


def protocol_block(plan_cfg, sim_cfg, hlp: str, dtype) -> dict:
    """The protocol stamp every battery artifact carries so that its
    numbers are reproducible and comparable across runs (the reference
    fixes these in `kinova_run_100_worlds.m:20-100` + compile-time
    `Parameters.h`; here they are runtime knobs, so they are RECORDED)."""
    return {
        "max_iterations": int(sim_cfg.max_iterations),
        "stop_threshold": int(sim_cfg.stop_threshold),
        "stop_rescue_attempts": int(sim_cfg.stop_rescue_attempts),
        "hlp": str(hlp),
        "nlp_outer_iters": int(plan_cfg.nlp_outer_iters),
        "nlp_inner_iters": int(plan_cfg.nlp_inner_iters),
        "nlp_num_starts": int(plan_cfg.nlp_num_starts),
        "num_time_steps": int(plan_cfg.num_time_steps),
        "obstacle_culling": bool(plan_cfg.obstacle_culling),
        "collision_bank_bf16": bool(plan_cfg.collision_bank_bf16),
        "dtype": (str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype)
                  else np.dtype(dtype).name),
    }


def summarize_episodes(summary, protocol: dict | None = None) -> dict:
    """Aggregate a batched EpisodeSummary into the paper's safety table.

    ``protocol``: optional ``protocol_block`` dict, embedded verbatim so
    the artifact states which protocol produced it."""
    g = to_numpy(summary.goal_reached)
    c = to_numpy(summary.collision)
    t = to_numpy(summary.torque_violation)
    j = to_numpy(summary.joint_limit_violation)
    u = to_numpy(summary.ultimate_bound_violation)
    s = to_numpy(summary.stopped)
    n = g.shape[0] if g.ndim else 1
    success = g & ~c & ~t & ~j & ~u
    return {
        **({"protocol": dict(protocol)} if protocol else {}),
        "n_worlds": int(n),
        "goal_reached": int(np.sum(g)),
        "success": int(np.sum(success)),
        "collision": int(np.sum(c)),
        "torque_violation": int(np.sum(t)),
        "joint_limit_violation": int(np.sum(j)),
        "ultimate_bound_violation": int(np.sum(u)),
        "stopped_safely": int(np.sum(s & ~c)),
        "mean_iterations": float(np.mean(to_numpy(summary.iterations))),
        "mean_feasible_plans": float(np.mean(to_numpy(summary.n_feasible_plans))),
    }


def format_summary(d: dict) -> str:
    lines = [f"worlds: {d['n_worlds']}"]
    for key in (
        "goal_reached", "success", "collision", "torque_violation",
        "joint_limit_violation", "ultimate_bound_violation", "stopped_safely",
    ):
        lines.append(f"{key:>26}: {d[key]:4d} / {d['n_worlds']}")
    lines.append(f"{'mean_iterations':>26}: {d['mean_iterations']:.1f}")
    lines.append(f"{'mean_feasible_plans':>26}: {d['mean_feasible_plans']:.1f}")
    return "\n".join(lines)
