"""One rank of the gloo scale-out tests (`tests/test_torch_parallel.py`).

Started by ``torch.multiprocessing`` with the spawn method; imports only the
port.  Reads the global inputs from ``<out_dir>/inputs.npz`` (the planner
configuration comes as ``PlannerConfig`` keywords), joins a gloo
group of ``world`` ranks over ``127.0.0.1:<port>``, builds the (dp, cp)
mesh and runs `sharded_plan_step`: with the starts given by the caller
(its dp rows), with no starts and a generator seeded ``100 + rank``,
different on every rank, with other poses and starts (``q0_2``,
``k_rand_2``), and in smooth collision mode (``smooth_collision_tau =
smooth_tau``) with the given starts.  The step is kept (the planner's
full-width program); the given, the second and the smooth calls run again
with ``eager=True`` beside it.  Writes every rank's view of the gathered
results, its own plans of the kept and the eager calls (``<case>_kept_*``,
``<case>_eager_*``), the cp gathers of each call, the programs' counts and
the starts the generator's step was given, to ``<out_dir>/rank<rank>.npz``.
"""

import dataclasses
import os

FIELDS = ("k", "feasible", "cost", "max_violation", "torque_radius")

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
        q0, qd0, qdd0, q_des, zonos, masks, k_rand, q0_2, k_rand_2 = scatter_worlds(
            mesh, *(inp[k] for k in ("q0", "qd0", "qdd0", "q_des", "zonos", "masks", "k_rand",
                                     "q0_2", "k_rand_2")))
        zonos, masks = cp_shard(mesh, zonos), cp_shard(mesh, masks)
        out = {"shape": np.array([mesh.size(0), mesh.size(1)]), "obstacle_shard": np.array(masks.shape)}
        used = []                  # the starts each solve was given
        solve = step.planner.solve

        def recording_solve(*args, **kw):
            used.append(kw["k_rand"].clone())
            return solve(*args, **kw)

        step.planner.solve = recording_solve

        def run(name, fn, *args, **kw):
            """The call kept and, for a ``name``, again with eager=True: each
            one's plans and cp gathers under ``<name>_kept`` / ``_eager``."""
            res = None
            for how in ("kept", "eager") if name else ("kept",):
                gather_obstacles.calls = 0
                r = fn(*args, **kw, eager=how == "eager")
                res = r if res is None else res
                if name:
                    out[f"{name}_{how}_gathers"] = np.array(gather_obstacles.calls)
                    out.update({f"{name}_{how}_{f}": getattr(r, f).numpy() for f in FIELDS})
            return res

        res = run("given", step, q0, qd0, qdd0, q_des, zonos, masks, k_rand=k_rand)
        out["gathers"] = out["given_kept_gathers"]
        own = run("", step, q0, qd0, qdd0, q_des, zonos, masks,
                  generator=torch.Generator().manual_seed(100 + rank))
        out["own_starts"] = used[-1].numpy()
        # other poses and starts through the same kept program
        run("second", step, q0_2, qd0, qdd0, q_des, zonos, masks, k_rand=k_rand_2)
        out["programs"] = np.array([step.planner.batch_programs.stats()[k]
                                    for k in ("misses", "hits", "evictions", "entries")])
        for name, r in (("given", res), ("own", own)):
            got = gather_summary({"k": r.k, "feasible": r.feasible,
                                  "max_violation": r.max_violation}, mesh)
            out.update({f"{name}_{k}": v for k, v in got.items()})
        # smooth mode gathers the smooth bound (and its Jacobian) on every
        # constraint pass and the explicit verification pool's values once
        smooth = sharded_plan_step(kinova_gen3_spec(),
                                   dataclasses.replace(cfg, smooth_collision_tau=smooth_tau),
                                   mesh, torch.float64)
        r = run("smooth", smooth, q0, qd0, qdd0, q_des, zonos, masks, k_rand=k_rand)
        out["smooth_gathers"] = out["smooth_kept_gathers"]
        got = gather_summary({"k": r.k, "feasible": r.feasible, "max_violation": r.max_violation},
                             mesh)
        out.update({f"smooth_{k}": v for k, v in got.items()})
        out["q0_roundtrip"] = gather_summary((q0,), mesh)[0]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
