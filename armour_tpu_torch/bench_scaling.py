"""Device-count scaling of the sharded planning step
(`scripts/bench_scaling.py`) through the port.

    python -m armour_tpu_torch.bench_scaling [--production] [--out rows.json]
    python -m armour_tpu_torch.bench_scaling --virtual 2 [--reps 1]

For each device count of (1, 2, 4, 8, 16, 32) up to the number of cards,
spawns one rank per card in an NCCL group (``run_sharded.spawn_ranks``).
With ``--virtual N`` the counts go up to N and the ranks are gloo processes
on the CPU instead, the counterpart of the JAX script's virtual CPU
devices: those rows show that the step runs at each count, not how it
scales (the ranks share one host).  Every rank runs ``sharded_plan_step``
with cp = 1 on the JAX script's problem: ``--worlds-per-device`` worlds
per rank at the fixed ``q0`` plus ``uniform(-0.2, 0.2)`` from numpy seed 0,
at rest, ``q_des = q0 + 0.4 k_range``, one 0.06 box at (0.5, 0.3, 0.5).
``--production`` plans at T=128 with 8 slots and the default 4-start 8x8
ALM; otherwise at ``--time-steps`` with 4 slots, 2 starts and a 4x4 ALM.
The step is kept per shape: its first call (which captures on a card) is
timed apart, then ``--reps`` replays one by one (each the slowest rank's
time); ``plans_per_s`` is read from the mean replay (all the replays'
work over all their time), the median replay kept beside it.  Rank 0
prints each row (``devices``, ``worlds``, ``plans_per_s``,
``plans_per_s_per_device``, ``first_call_s``, ``replay_s``), and with two
rows or more the ``scaling_efficiency`` of the last over the first.
``--out`` writes them with the keys of the JAX script's rows and, on
cards, the step times (``steps``) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from armour_tpu_torch.run_sharded import free_port, spawn_ranks

COUNTS = (1, 2, 4, 8, 16, 32)
Q0 = (0.65, -0.09, -0.48, -1.23, -1.57, -1.07, 0.0)


def planner_config(args):
    from armour_tpu_torch.config import PlannerConfig

    if args.production:
        return PlannerConfig(num_time_steps=128, max_obstacles=8)
    return PlannerConfig(num_time_steps=args.time_steps, max_obstacles=4, nlp_num_starts=2,
                         nlp_outer_iters=4, nlp_inner_iters=4)


def problem(cfg, B: int):
    """The JAX script's worlds, as numpy arrays (q0, qd0, qdd0, q_des, zonos, masks)."""
    rng = np.random.default_rng(0)
    q0 = (np.tile(Q0, (B, 1)) + rng.uniform(-0.2, 0.2, (B, 7))).astype(np.float32)
    zeros = np.zeros((B, 7), np.float32)
    q_des = (q0 + 0.4 * np.asarray(cfg.k_range)).astype(np.float32)
    zonos = np.zeros((B, cfg.max_obstacles, 4, 3), np.float32)
    zonos[:, 0, 0] = (0.5, 0.3, 0.5)
    zonos[:, 0, 1:] = 0.06 * np.eye(3)
    masks = np.zeros((B, cfg.max_obstacles), bool)
    masks[:, 0] = True
    return q0, zeros, zeros, q_des, zonos, masks


def _rank(rank, n, args, port, out_path):
    import torch.distributed as dist

    from armour_tpu_torch.parallel.mesh import mesh_device, sharded_plan_step
    from armour_tpu_torch.parallel.multihost import global_planner_mesh, init_distributed, scatter_worlds
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec

    device = "cpu" if args.virtual else "cuda"
    if args.virtual:
        torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", n, rank, device=device)
    try:
        mesh = global_planner_mesh(1, device=device)
        dev = mesh_device(mesh)
        cfg = planner_config(args)
        step = sharded_plan_step(kinova_gen3_spec(), cfg, mesh, torch.float32)
        B = args.worlds_per_device * n
        k_rand = step.planner.random_starts(B, torch.Generator(device=dev).manual_seed(0)).cpu()
        *worlds, k_local = scatter_worlds(mesh, *problem(cfg, B), k_rand)

        times = []
        for _ in range(1 + args.reps):           # the first call, then the replays
            dist.barrier()
            t0 = time.perf_counter()
            res = step(*worlds, k_rand=k_local)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = torch.tensor(times, dtype=torch.float64, device=dev)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)               # the slowest rank's step
        feasible = torch.tensor([int(res.feasible.sum())], device=dev)
        dist.all_reduce(feasible)
        if rank == 0:
            first, *replays = dt.tolist()
            sec = sum(replays) / len(replays)
            with open(out_path, "w") as f:
                json.dump({"devices": n, "worlds": B, "plans_per_s": round(B / sec, 2),
                           "plans_per_s_per_device": round(B / sec / n, 2),
                           "first_call_s": first, "replay_s": replays,
                           "seconds_per_step": sec, "median_replay_s": statistics.median(replays),
                           "feasible": int(feasible),
                           "programs": step.planner.batch_programs.stats()}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="N gloo ranks on the CPU (0 = one rank per card)")
    ap.add_argument("--worlds-per-device", type=int, default=2)
    ap.add_argument("--time-steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--production", action="store_true",
                    help="the production shapes (T=128, 8 slots, bf16 bank, 4-start 8x8 ALM)")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds per device count")
    ap.add_argument("--out", default="", help="write the rows here")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps: at least one replay")
    if args.production:
        args.time_steps = 128
    if args.virtual:
        n_dev = args.virtual
    else:
        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling: no CUDA device is available; "
                             "use --virtual N for gloo ranks on the CPU")
        n_dev = torch.cuda.device_count()
        from armour_tpu_torch.collision import kernels

        kernels.build()          # once, before the ranks load it
    rows, steps = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for n in (c for c in COUNTS if c <= n_dev):
            out_path = os.path.join(tmp, f"row{n}.json")
            if not spawn_ranks(_rank, n, (n, args, free_port(), out_path), args.timeout,
                               "bench_scaling"):
                raise SystemExit(1)
            with open(out_path) as f:
                row = json.load(f)
            rows.append({k: row[k] for k in ("devices", "worlds", "plans_per_s",
                                             "plans_per_s_per_device")})
            steps.append({k: row[k] for k in ("devices", "first_call_s", "replay_s", "seconds_per_step",
                                              "median_replay_s", "programs")})
            print(json.dumps(row), flush=True)
    summary = {}
    if len(rows) >= 2:
        eff = rows[-1]["plans_per_s_per_device"] / rows[0]["plans_per_s_per_device"]
        summary = {"scaling_efficiency": round(eff, 3), "from_devices": rows[0]["devices"],
                   "to_devices": rows[-1]["devices"]}
        print(json.dumps(summary))
    out = {"virtual_devices": args.virtual, "time_steps": args.time_steps,
           "note": ("gloo ranks on one host's CPU: the rows show that the sharded step runs "
                    "at each device count, not per-device scaling") if args.virtual else "",
           "rows": rows, **summary}
    if not args.virtual:           # the card's extras: the step times, the card
        out["steps"] = steps
        out["device"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
