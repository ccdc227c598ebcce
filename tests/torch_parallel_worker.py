"""One rank of the gloo scale-out tests (`tests/test_torch_parallel.py`).

Started by ``torch.multiprocessing`` with the spawn method; imports only the
port.  Reads the global inputs from ``<out_dir>/inputs.npz`` (the planner
configuration comes as ``PlannerConfig`` keywords), joins a gloo
group of ``world`` ranks over ``127.0.0.1:<port>``, builds the (dp, cp)
mesh and runs `sharded_plan_step` three times: with the starts given by
the caller (its dp rows), with no starts and a generator seeded
``100 + rank``, different on every rank, and in smooth collision mode
(``smooth_collision_tau = smooth_tau``) with the given starts.  Writes every
rank's view of the gathered results, the cp gathers of the first and the
smooth step, and the starts the second step's solve was given, to
``<out_dir>/rank<rank>.npz``.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


def run(rank, world, port, cp_size, out_dir, cfg_kw, smooth_tau):
    torch.set_num_threads(1)
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.parallel.mesh import cp_shard, sharded_plan_step
    from armour_tpu_torch.parallel.multihost import (
        gather_summary,
        global_planner_mesh,
        init_distributed,
        scatter_worlds,
    )
    from armour_tpu_torch.planner.armour import gather_obstacles
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec

    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (world, rank)
    try:
        mesh = global_planner_mesh(cp_size)
        cfg = PlannerConfig(**cfg_kw)
        step = sharded_plan_step(kinova_gen3_spec(), cfg, mesh, torch.float64)
        q0, qd0, qdd0, q_des, zonos, masks, k_rand = scatter_worlds(
            mesh, *(inp[k] for k in ("q0", "qd0", "qdd0", "q_des", "zonos", "masks", "k_rand")))
        zonos, masks = cp_shard(mesh, zonos), cp_shard(mesh, masks)
        out = {"shape": np.array([mesh.size(0), mesh.size(1)]), "obstacle_shard": np.array(masks.shape)}
        used = []                  # the starts each solve was given
        solve = step.planner.solve

        def recording_solve(*args, **kw):
            used.append(kw["k_rand"].clone())
            return solve(*args, **kw)

        step.planner.solve = recording_solve
        gather_obstacles.calls = 0
        res = step(q0, qd0, qdd0, q_des, zonos, masks, k_rand=k_rand)
        out["gathers"] = np.array(gather_obstacles.calls)
        for name, r in (("given", res),
                        ("own", step(q0, qd0, qdd0, q_des, zonos, masks,
                                     generator=torch.Generator().manual_seed(100 + rank)))):
            got = gather_summary({"k": r.k, "feasible": r.feasible,
                                  "max_violation": r.max_violation}, mesh)
            out.update({f"{name}_{k}": v for k, v in got.items()})
        out["own_starts"] = used[-1].numpy()
        # smooth mode gathers the smooth bound (and its Jacobian) on every
        # constraint pass and the explicit verification pool's values once
        smooth = sharded_plan_step(kinova_gen3_spec(),
                                   dataclasses.replace(cfg, smooth_collision_tau=smooth_tau),
                                   mesh, torch.float64)
        gather_obstacles.calls = 0
        r = smooth(q0, qd0, qdd0, q_des, zonos, masks, k_rand=k_rand)
        out["smooth_gathers"] = np.array(gather_obstacles.calls)
        got = gather_summary({"k": r.k, "feasible": r.feasible, "max_violation": r.max_violation},
                             mesh)
        out.update({f"smooth_{k}": v for k, v in got.items()})
        out["q0_roundtrip"] = gather_summary((q0,), mesh)[0]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
