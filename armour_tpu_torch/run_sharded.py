"""The (dp, cp) scale-out on several ranks, held against one rank's plan.

    python -m armour_tpu_torch.run_sharded [--ranks 4] [--cp 2] [--batch 128]
        [--time-steps 128] [--dtype float32] [--device cuda] [--reps 1]
        [--timeout 900]

Starts ``--ranks`` processes (``torch.multiprocessing``, spawn), one per
card, in an NCCL group over a free ``127.0.0.1`` port (gloo with
``--device cpu``), and builds the (ranks / cp, cp) mesh.  Every rank makes
the same ``problem_set`` worlds (seed 0, 8 obstacles, the 8 slots of their
bucket) and random starts, keeps its dp rows (``scatter_worlds``) and its
cp slice of the slots (``cp_shard``), and runs ``sharded_plan_step``, kept
per shape: its first call (which captures on a card) and ``--reps``
replays, each timed.  ``gather_summary`` brings every world's plan to
every rank.  Rank 0 then plans the same worlds with ``plan_batch`` on its
own device, with the same slots and starts, and prints one JSON line: the
mesh, the first call's and each replay's seconds, seconds per step (the
mean replay) and plans/s, the cp gathers and main-kernel launches of the
last replay, the summary gather's seconds, and the largest
``|k_sharded - k_plan_batch|``.  It exits 1 when
``feasible`` differs or a ``k`` differs by more than 2e-6 (the JAX
scale-out test's tolerance), and kills the ranks and fails when they have
not ended within ``--timeout`` seconds.  On the CPU (a rehearsal at a
small size) each rank runs one thread.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ATOL = 2e-6


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for the process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(fn, nprocs: int, args: tuple, timeout: float, name: str) -> bool:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; False, with the
    ranks killed, when they have not ended within ``timeout`` seconds.  A
    rank that raises makes this raise."""
    ctx = torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                print(f"{name}: the ranks did not end within {timeout} s", file=sys.stderr)
                return False
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return True


def _rank(rank, args, port, out_path):
    import torch.distributed as dist

    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.parallel.mesh import cp_shard, mesh_device, sharded_plan_step
    from armour_tpu_torch.parallel.multihost import (
        gather_summary,
        global_planner_mesh,
        init_distributed,
        scatter_worlds,
    )
    from armour_tpu_torch.planner.armour import ArmourPlanner, gather_obstacles, obstacle_bucket
    from armour_tpu_torch.problems import problem_set
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec

    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", args.ranks, rank, device=args.device)
    try:
        mesh = global_planner_mesh(args.cp, device=args.device)
        dev = mesh_device(mesh)
        dtype = getattr(torch, args.dtype)
        spec, cfg = kinova_gen3_spec(), PlannerConfig(num_time_steps=args.time_steps)
        p = problem_set(cfg, args.batch, n_obs=8, seed=0, device=dev)
        slots = obstacle_bucket(p.masks)
        zonos, masks = p.zonos[:, :slots], p.masks[:, :slots]
        step = sharded_plan_step(spec, cfg, mesh, dtype)
        k_rand = step.planner.random_starts(
            args.batch, torch.Generator(device=dev).manual_seed(0)).cpu()
        q0, qd0, qdd0, q_des, k_local = scatter_worlds(mesh, p.q0, p.qd0, p.qdd0, p.q_des, k_rand)
        z_local, m_local = (cp_shard(mesh, x) for x in scatter_worlds(mesh, zonos, masks))
        times = []
        for _ in range(1 + args.reps):      # the first call, then the replays
            _sync(dev)
            kernels.reset_launch_counts()
            gather_obstacles.calls = 0
            t0 = time.perf_counter()
            res = step(q0, qd0, qdd0, q_des, z_local, m_local, k_rand=k_local)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        first_s, replay_s = times[0], times[1:]
        step_s = sum(replay_s) / len(replay_s)
        launches = kernels.launch_counts()["fused_collision_value_jac_multi"]
        cp_gathers = gather_obstacles.calls
        t0 = time.perf_counter()
        got = gather_summary({"k": res.k, "feasible": res.feasible}, mesh)
        gather_s = time.perf_counter() - t0
        if rank != 0:
            return
        ref = ArmourPlanner(spec, cfg, dtype, device=dev).plan_batch(
            p.q0, p.qd0, p.qdd0, p.q_des, zonos, masks, k_rand=k_rand)
        k_ref, f_ref = ref.k.cpu().numpy(), ref.feasible.cpu().numpy()
        both = f_ref & got["feasible"]
        out = {"backend": dist.get_backend(), "ranks": args.ranks,
               "mesh": {"dp": mesh.size(0), "cp": mesh.size(1)}, "batch": args.batch,
               "T": args.time_steps, "dtype": args.dtype, "obstacle_slots": slots,
               "slots_per_rank": int(m_local.shape[1]), "first_call_s": first_s,
               "replay_s": replay_s, "seconds_per_step": step_s,
               "plans_per_s": args.batch / step_s, "cp_gathers_per_step": cp_gathers,
               "main_kernel_launches_rank0": launches, "summary_gather_s": gather_s,
               "feasible_fraction": float(got["feasible"].mean()),
               "feasible_equal": bool(np.array_equal(f_ref, got["feasible"])),
               "max_abs_k_diff": float(np.abs(got["k"][both] - k_ref[both]).max()) if both.any() else 0.0,
               "atol": ATOL}
        if dev.type == "cuda":
            out["device"] = torch.cuda.get_device_name(dev)
            out["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cp", type=int, default=2)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=1, help="replays timed after the first call")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps: at least one replay")
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"run_sharded: {args.ranks} ranks need as many cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if args.device == "cuda":
        from armour_tpu_torch.collision import kernels

        kernels.build()      # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        if not spawn_ranks(_rank, args.ranks, (args, free_port(), out_path), args.timeout,
                           "run_sharded"):
            return 1
        with open(out_path) as f:
            out = json.load(f)
    print(json.dumps(out), flush=True)
    ok = out["feasible_equal"] and out["max_abs_k_diff"] <= ATOL
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
