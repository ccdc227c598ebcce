#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the ARMOUR planner on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. device   card name and power limit, torch/CUDA versions, TF32 flags
  2. build    nvcc build of armour_tpu_torch/csrc/collision_bank.cu; fails
              if ptxas reports a spill in any instantiation
  3. kernels  each of the three collision kernels against its plain PyTorch
              version on a bank built by the planner's own main path
              (seed 0, B=128, T=128, bucket 8, bf16 A; then an f64 bank),
              with CUDA-event times, bytes moved and the memory/compute bound;
              the values-only kernel also at the 10 candidates of the
              smooth-mode verification pool, the value + Jacobian kernel also
              at 12 starts (two launches) and on the 40-obstacle bank
              (bucket 16); then small random banks at T=32 (staged path) and
              at a slab whose rows are not 16-byte aligned (direct path)
  4. main     ArmourPlanner.plan_batch at B=128, T=128, 8 obstacles: time,
              feasibility and kernel launches per plan; then the 40-obstacle
              point and the batch-1 latency; then the collision check of the
              returned plans (values_multi and single-start value_jac)
  5. modes    one plan_batch at the same width for traj_type="orig", with
              12 starts, for smooth collision (tau = 1e-3) and with grasp
              constraints
  6. track    one closed-loop rollout of the 128 plans of phase 4: robust
              controller, RK4 plant at 5e-4 s, 200 steps, all worlds at once
  7. parity   plan() on the card against plan() on the CPU (4 worlds, then
              one world per mode) and a 20-step rollout, T=32, f64
  8. battery  run_batch_stepped over the 100 worlds of assets/worlds at
              B=100, T=128, f32, 2 iterations, mesh oracle: one JSON line per
              iteration (wall split, buckets, launches = 65, mesh hits), the
              summary; fails on any safety violation.  The main kernel is held
              against its plain version on the battery's first bank
  9. hard     the doorway scene with up-front RRT-connect guidance, 2
              iterations
 10. episode  EpisodeRunner.run_batch on 4 worlds and run_recorded_episode on
              one (save/load round trip), 1 iteration each
 11. parity   run_batch_stepped on the card against the CPU: 2 worlds, T=32,
              f64, the same injected draws; every summary field equal
The last lines are the kernel table as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Longer output goes to chiprun_out/.
"""

import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# peak memory bandwidth (bytes/s) and float32 rate outside the tensor cores
# (FLOP/s) of the cards this script has run on, from NVIDIA's data sheet
# (dense, no sparsity, 700 W); another card needs its own row first
_PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),  # H100 SXM5
)
_OPS_PER_PIECE = 10  # per (slot, start, pair): 3 mul + 2 add (A.c), 2 sub, 1 neg, 2 compares
_OPS_PER_JAC = 5     # per (slot, start, k): 3 mul + 2 add


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, bw, fl in _PEAKS:
        if key in name:
            return key, bw, fl
    raise RuntimeError(f"no peak figures for card {name!r}")


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall(torch, fn, reps):
    """Median host wall time (s) of fn() ending in a device synchronise."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def count_tensor_calls(fn) -> int:
    """Tensor-library calls (kernel launches AND views) that fn() makes from
    Python: what the host pays for, whatever reaches the device."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Counter.calls += 1
            return func(*args, **(kwargs or {}))

    with Counter():
        fn()
    return Counter.calls


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


SAFETY = ("collision", "torque_violation", "joint_limit_violation", "ultimate_bound_violation")
SUMMARY_FIELDS = ("goal_reached", *SAFETY, "stopped", "iterations", "n_feasible_plans")


def episode_phases(torch, dev, check_and_time, rows, out_dir, n_worlds=100, T=128, sim_kw=None):
    """Phases 8-11, the receding-horizon episode paths: the 100-world battery,
    the doorway scene, the episode program and the recorded episode, and the
    battery driver on the card against the CPU.  Every phase resets the
    launch counts just before it and reads them just after.  ``n_worlds``,
    ``T`` and ``sim_kw`` (SimConfig overrides) exist to rehearse the phases
    at a small size on the CPU."""
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.collision.zonotope import kernel_layout
    from armour_tpu_torch.config import PlannerConfig, SimConfig
    from armour_tpu_torch.planner.armour import obstacle_bucket
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim.harness import Draws, EpisodeRunner, TrueParams, run_batch_stepped
    from armour_tpu_torch.sim.recording import load_recording, run_recorded_episode
    from armour_tpu_torch.sim.scenarios import hard_scenario, load_world_csv, stack_worlds
    from armour_tpu_torch.utils.summary import summarize_episodes

    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=T)
    sim_kw = sim_kw or {}
    f32, f64 = torch.float32, torch.float64
    main_name = "fused_collision_value_jac_multi"
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
    zero = {k.__name__: 0 for k in kernels.KERNELS}

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def safe(s, label):
        bad = {k: int(getattr(s, k).sum()) for k in SAFETY}
        assert not any(bad.values()), f"{label}: safety violations {bad}"
        return bad

    def overshoots(s):
        return {k: float(getattr(s, k).max()) for k in ("jl_overshoot", "ub_overshoot",
                                                        "torque_overshoot")}

    # ---- 8. battery: the 100-world suite, as run_100_worlds loads it ----
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, "assets", "worlds", "*.csv")))[:n_worlds]
    assert len(files) == n_worlds, f"{len(files)} world files"
    worlds = [load_world_csv(f, cfg.max_obstacles, f32, device=dev) for f in files]
    starts, goals, zonos, masks = stack_worlds(worlds, f32)
    B = len(worlds)
    runner = EpisodeRunner(spec, cfg, SimConfig(max_iterations=2, **sim_kw), f32, device=dev)
    planner = runner.planner
    rest = torch.zeros_like(starts)
    # the bank of the first replan (the arm at rest at its start), the whole
    # batch and by obstacle count
    prob = planner.build_probs(starts, rest, rest, zonos, masks)
    n_live = masks.sum(1).cpu()
    by_count = {}
    for n in sorted(set(n_live.tolist())):
        sel = (n_live == n).to(starts.device)
        p_n = planner.build_probs(starts[sel], rest[sel], rest[sel], zonos[sel], masks[sel])
        by_count[int(n)] = {"worlds": int(sel.sum()), "bucket": obstacle_bucket(masks[sel]),
                            "bucket_culled": int(p_n.hp.dpos.shape[-2])}
    del p_n
    gen = torch.Generator(device=dev).manual_seed(0)
    trace = []
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s = run_batch_stepped(runner, starts, goals, zonos, masks, gen, collision_oracle="mesh",
                          hlp="straight", trace=trace)
    sync()
    battery_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for tr in trace:
        emit({"phase": "battery_iteration", **tr})
        assert tr["launches"] == dict(zero, **{main_name: passes}), tr["launches"]
    assert counts == dict(zero, **{main_name: passes * len(trace)}), counts
    summary = summarize_episodes(s)
    with open(os.path.join(out_dir, "battery_trace.json"), "w") as f:
        json.dump({"trace": trace, "summary": summary,
                   "worlds": [os.path.basename(x) for x in files]}, f, indent=1)
    emit({"phase": "battery", "worlds": B, "T": T, "dtype": "float32", "hlp": "straight",
          "collision_oracle": "mesh", "iterations": len(trace), "seconds": battery_s,
          "seconds_per_iteration": battery_s / max(len(trace), 1), "launches": counts,
          "bucket_first_replan": {"bucket": obstacle_bucket(masks),
                                  "bucket_culled": int(prob.hp.dpos.shape[-2]),
                                  "by_obstacle_count": by_count},
          "summary": summary, "max_overshoot": overshoots(s)})
    safe(s, "battery")
    # the main kernel on the battery's first bank, against its plain version
    hp = prob.hp
    K = torch.as_tensor(np.random.default_rng(6).uniform(-0.9, 0.9, (B, cfg.nlp_num_starts, 7)),
                        dtype=f32, device=dev)
    c, dc = kernel_layout(*prob.links.slice_with_jac_multi(K)[::2])
    battery_row = "fused_collision_value_jac_multi[battery]"
    check_and_time(hp, f32, 2e-6, kernels.fused_collision_value_jac_multi,
                   (hp.A, hp.dpos, hp.dneg, c, dc), True,
                   kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5), battery_row, timed=True)
    rows[battery_row]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[battery_row]["launches"] = counts[main_name]
    del prob, hp, K, c, dc
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    # ---- 9. hard: the doorway with up-front configuration-space RRT-connect ----
    door = hard_scenario(2, cfg.max_obstacles, f32, device=dev)
    hrunner = EpisodeRunner(spec, cfg, SimConfig(max_iterations=2, goal_radius=0.05, **sim_kw),
                            f32, device=dev)
    trace_h = []
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s_h = run_batch_stepped(hrunner, *stack_worlds([door], f32),
                            torch.Generator(device=dev).manual_seed(0),
                            collision_oracle="mesh", hlp="rrt_connect", trace=trace_h)
    sync()
    hard_s = time.perf_counter() - t0
    counts_h = kernels.launch_counts()
    assert counts_h == dict(zero, **{main_name: passes * len(trace_h)}), counts_h
    paths = trace_h[-1]["guidance_paths"] if trace_h else {}
    emit({"phase": "hard", "scenario": 2, "name": "doorway", "hlp": "rrt_connect",
          "iterations": len(trace_h), "seconds": hard_s,
          "up_front_host_s": hard_s - sum(tr["wall_s"] for tr in trace_h),
          "iteration_s": [tr["wall_s"] for tr in trace_h],
          "guidance_path": paths.get("0"),
          "waypoints_consumed": paths["0"]["index"] - 1 if "0" in paths else None,
          "launches": counts_h,
          "flags": {k: bool(getattr(s_h, k)[0]) for k in SUMMARY_FIELDS[:6]},
          "n_feasible_plans": int(s_h.n_feasible_plans[0]), "max_overshoot": overshoots(s_h)})
    safe(s_h, "hard")
    assert "0" in paths, "hard: RRT-connect found no guidance path through the doorway"

    # ---- 10. episode: the episode program and the recorded episode ----
    erunner = EpisodeRunner(spec, cfg, SimConfig(max_iterations=1, **sim_kw), f32, device=dev)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s_e = erunner.run_batch(starts[:4], goals[:4], zonos[:4], masks[:4],
                            torch.Generator(device=dev).manual_seed(0))
    sync()
    scan_s = time.perf_counter() - t0
    counts_e = kernels.launch_counts()
    assert counts_e == dict(zero, **{main_name: passes}), counts_e
    safe(s_e, "episode program")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rec = run_recorded_episode(spec, cfg, SimConfig(max_iterations=1, **sim_kw), worlds[0],
                               torch.Generator(device=dev).manual_seed(0), f32,
                               planner=erunner.planner)
    sync()
    rec_s = time.perf_counter() - t0
    counts_r = kernels.launch_counts()
    assert counts_r == dict(zero, **{main_name: passes}), counts_r
    assert len(rec.records) == 1 and not rec.collision
    path = os.path.join(out_dir, "episode_world0.npz")
    rec.save(path)
    z = load_recording(path)
    r0 = rec.records[0]
    assert np.array_equal(z["q"], r0.q) and np.array_equal(z["k"][0], r0.k, equal_nan=True)
    assert z["q"].shape == r0.q.shape and np.isfinite(z["q"]).all()
    emit({"phase": "episode", "run_batch": {"worlds": 4, "iterations": 1, "seconds": scan_s,
                                             "launches": counts_e,
                                             "n_feasible_plans": s_e.n_feasible_plans.tolist(),
                                             "goal_reached": s_e.goal_reached.tolist()},
          "recorded": {"world": os.path.basename(files[0]), "iterations": 1, "seconds": rec_s,
                       "launches": counts_r, "feasible": bool(r0.feasible),
                       "saved_arrays": len(z), "log_steps": int(z["q"].shape[0])}})

    # ---- 11. the battery driver on the card against the CPU ----
    cfg32 = PlannerConfig(num_time_steps=32)
    sim2 = SimConfig(plant_dt=5e-3, max_iterations=2)
    w2 = stack_worlds([load_world_csv(f, cfg32.max_obstacles, f64, device="cpu") for f in files[:2]],
                      f64)
    g = torch.Generator().manual_seed(9)
    lo, hi = sim2.uncertain_mass_range
    tp = TrueParams(*(torch.rand((2, 7), generator=g, dtype=f64) * (hi - lo) + lo for _ in "mi"))
    draws = [(torch.rand((2, max(cfg32.nlp_num_starts - 2, 1), 7), generator=g, dtype=f64) * 1.2 - 0.6,
              torch.randn((2, 32, 7), generator=g, dtype=f64)) for _ in range(sim2.max_iterations)]
    out = {}
    for d in (dev, "cpu"):
        kernels.reset_launch_counts()
        r = EpisodeRunner(spec, cfg32, sim2, f64, device=d)
        out[d] = run_batch_stepped(r, *w2, true_params=tp,
                                   draws=lambda i, d=d: Draws(*(x.to(d) for x in draws[i])),
                                   collision_oracle="mesh")
        if d == dev:
            card_counts = kernels.launch_counts()
    a, b = out[dev], out["cpu"]
    for name in SUMMARY_FIELDS:
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), \
            f"stepped: {name} card {getattr(a, name).tolist()} CPU {getattr(b, name).tolist()}"
    over_diff = max(float((getattr(a, k) - getattr(b, k)).abs().max())
                    for k in ("jl_overshoot", "ub_overshoot", "torque_overshoot"))
    assert over_diff <= 1e-9, f"stepped: overshoots differ by {over_diff}"
    emit({"phase": "card_vs_cpu", "path": "run_batch_stepped", "worlds": 2, "T": 32,
          "dtype": "float64", "iterations": sim2.max_iterations, "fields_equal": True,
          "max_abs_overshoot_diff": over_diff, "atol": 1e-9, "card_launches": card_counts,
          "n_feasible_plans": a.n_feasible_plans.tolist()})
    return battery_row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import armour_tpu_torch  # noqa: F401  (sets the TF32 flags)
    except ImportError as e:
        print(f"chip_smoke: the armour_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.collision.zonotope import (
        BufferedHyperplanes,
        ObstacleSet,
        collision_constraints_with_jac,
        collision_values_multi,
        kernel_layout,
        mask_dead,
    )
    from armour_tpu_torch.config import GraspConfig, PlannerConfig, SimConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.problems import Q_HOME, problem_set
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim.agent import TrajParams, TrueParams, rollout
    from armour_tpu_torch.sim.world import arm_collision_check

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()

    # ---- 1. device -------------------------------------------------------
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    peak_key, peak_bw, peak_f32 = peaks(card)
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    emit({"phase": "device", "nvidia_smi": smi, "device_name": card,
          "device_count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0], "allow_tf32": tf32,
          "peaks_row": peak_key, "peak_bytes_per_s": peak_bw, "peak_f32_flops": peak_f32})
    assert not tf32["matmul"] and not tf32["cudnn"], "TF32 must be off"

    # ---- 2. build --------------------------------------------------------
    from armour_tpu_torch.collision import mesh_oracle

    with ThreadPoolExecutor(2) as pool:    # nvcc and g++ at once
        oracle_build = pool.submit(mesh_oracle.build)
        info = kernels.build(verbose=True)
        oracle_lib = oracle_build.result()
    with open(os.path.join(out_dir, "collision_bank_ptxas.txt"), "w") as f:
        f.write(info["log"])
    ptxas = kernels.ptxas_summary(info["log"])
    spilling = [r for r in ptxas if r["spill_stores"] or r["spill_loads"]]
    emit({"phase": "build", "seconds": round(info["seconds"], 3), "built": info["built"],
          "library": os.path.relpath(info["path"]), "instantiations": len(ptxas),
          "registers_f32_offsets": {r["kernel"]: r["registers"] for r in ptxas if ",f32," in r["kernel"]},
          "max_registers": max((r["registers"] for r in ptxas), default=None), "spilling": spilling,
          "mesh_oracle": os.path.relpath(oracle_lib),
          "mesh_oracle_openmp": oracle_lib == mesh_oracle.library_path(mesh_oracle.VARIANTS[0])})
    assert not info["built"] or (ptxas and not spilling), f"ptxas reports spills: {spilling}"

    spec = kinova_gen3_spec()
    cfg = PlannerConfig()
    dev = "cuda"
    B, S, n = 128, cfg.nlp_num_starts, spec.n_factors

    # ---- 3. kernels against their plain versions -------------------------
    probs8 = problem_set(cfg, B, n_obs=8, seed=0, device=dev)
    K_np = np.random.default_rng(1).uniform(-0.9, 0.9, (B, S, n))
    S_pool = 2 * S + 2   # the smooth-mode verification pool: ONE values-only launch
    K_pool_np = np.random.default_rng(3).uniform(-0.9, 0.9, (B, S_pool, n))
    pool_name = f"fused_collision_values_multi[S={S_pool}]"
    S_many = 12          # more starts than one value + Jacobian launch takes: two launches
    K_many_np = np.random.default_rng(5).uniform(-0.9, 0.9, (B, S_many, n))
    many_name = f"fused_collision_value_jac_multi[S={S_many}]"
    wide_name = "fused_collision_value_jac_multi[O=16]"   # the 40-obstacle bank
    rows = {}

    def check_and_time(hp, dtype, tol, kern, args, jac, uniq, name, timed, table=rows):
        """Hold kern(*args) against its plain version (Jacobians on the slots
        `uniq` whose winner is no tie) and note the error in `table`; with
        `timed`, add the row's times."""
        plain = kernels.PLAIN[kern]
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        single = kern is kernels.fused_collision_value_jac
        if jac:
            gk, Jk = got
            gp, Jp = ref
            if single:
                gk, Jk, gp, Jp = gk[:, None], Jk[:, None], gp[:, None], Jp[:, None]
            gk, Jk = mask_dead(hp, gk, Jk)
            gp, Jp = mask_dead(hp, gp, Jp)
            u = uniq[:, :, None]
            err_g = (gk - gp).abs().max().item()
            err_J = ((Jk - Jp).abs() * u).max().item()
        else:
            err_g = (mask_dead(hp, got) - mask_dead(hp, ref)).abs().max().item()
            err_J = 0.0
        ok = err_g <= tol and err_J <= tol and bool(torch.isfinite(gk if jac else got).all())
        row = table.setdefault(name, {})
        row[f"max_abs_err_{str(dtype)[6:]}"] = max(err_g, err_J)
        emit({"phase": "kernel_check", "kernel": name, "dtype": str(dtype)[6:],
              "A_dtype": str(hp.A.dtype)[6:], "shape_bank": list(hp.A.shape),
              "err_g": err_g, "err_J_tie_masked": err_J, "atol": tol,
              "unique_fraction": round(float(uniq.float().mean()), 6), "ok": ok})
        assert ok, f"{name} disagrees with its plain version in {dtype}"
        if not timed:
            return
        # times at the main path's shapes (f32 offsets, bf16 A)
        outs = got if jac else (got,)
        Sx = 1 if single else args[3].shape[1]
        Bk, P, _, L, O, T = hp.A.shape
        ops = Bk * Sx * L * O * T * (P * _OPS_PER_PIECE + (n * _OPS_PER_JAC if jac else 0))
        moved = nbytes(*args, *outs)
        b_mem, b_ops = moved / peak_bw * 1e3, ops / peak_f32 * 1e3
        row.update({
            "name": name, "wrapper": kern.__name__, "route": "cuda",
            "source": "armour_tpu_torch/csrc/collision_bank.cu",
            "ms": time_ms(torch, lambda: kern(*args)),
            "plain_ms": time_ms(torch, lambda: plain(*args), reps=20, warmup=2),
            "bytes": moved, "ops": ops,
            "bound_ms": max(b_mem, b_ops), "bound_by": "bytes" if b_mem >= b_ops else "operations",
            "library_ms": None,
            "shapes": {"B": Bk, "S": Sx, "n": n, "P": P, "L": L, "O": O, "T": T},
        })
        emit({"phase": "kernel_time", **{k: row[k] for k in
              ("name", "ms", "plain_ms", "bytes", "bound_ms", "bound_by", "shapes")}})

    for dtype, tol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
        planner = ArmourPlanner(spec, cfg, dtype=dtype, device=dev)
        prob = planner.build_probs(probs8.q0, probs8.qd0, probs8.qdd0, probs8.zonos, probs8.masks)
        hp = prob.hp
        K = torch.as_tensor(K_np, dtype=dtype, device=dev)
        centers, _, dcenters = prob.links.slice_with_jac_multi(K)
        c, dc = kernel_layout(centers, dcenters)
        unique = kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5)  # (B, S, L, O, T)
        c_pool = kernel_layout(prob.links.slice_with_jac_multi(
            torch.as_tensor(K_pool_np, dtype=dtype, device=dev))[0])
        cases = (
            (kernels.fused_collision_value_jac_multi, (hp.A, hp.dpos, hp.dneg, c, dc), True, unique, None),
            (kernels.fused_collision_values_multi, (hp.A, hp.dpos, hp.dneg, c), False, unique, None),
            (kernels.fused_collision_value_jac,
             (hp.A, hp.dpos, hp.dneg, c[:, 0].contiguous(), dc[:, 0].contiguous()), True,
             unique[:, :1], None),
            (kernels.fused_collision_values_multi, (hp.A, hp.dpos, hp.dneg, c_pool), False, unique,
             pool_name),
        )
        for kern, args, jac, uniq, row_name in cases:
            check_and_time(hp, dtype, tol, kern, args, jac, uniq, row_name or kern.__name__,
                           timed=dtype == torch.float32)
        # more starts than one launch takes: chunks of 8, one counted launch each
        c_many, dc_many = kernel_layout(*prob.links.slice_with_jac_multi(
            torch.as_tensor(K_many_np, dtype=dtype, device=dev))[::2])
        many = (hp.A, hp.dpos, hp.dneg, c_many, dc_many)
        kernels.reset_launch_counts()
        kernels.fused_collision_value_jac_multi(*many)
        assert kernels.launch_counts()["fused_collision_value_jac_multi"] == 2
        check_and_time(hp, dtype, tol, kernels.fused_collision_value_jac_multi, many, True,
                       kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c_many, tol=1e-5), many_name,
                       timed=dtype == torch.float32)
        del many, c_many, dc_many
        del planner, prob, hp, c, dc, c_pool, centers, dcenters, unique
        torch.cuda.empty_cache()
    # the 40-obstacle bank (seed 7: culled and compacted to bucket 16) through the main kernel
    probs40 = problem_set(cfg, B, n_obs=40, seed=7, device=dev)
    planner = ArmourPlanner(spec, cfg, dtype=torch.float32, device=dev)
    prob = planner.build_probs(probs40.q0, probs40.qd0, probs40.qdd0, probs40.zonos, probs40.masks)
    hp = prob.hp
    c, dc = kernel_layout(*prob.links.slice_with_jac_multi(
        torch.as_tensor(K_np, dtype=torch.float32, device=dev))[::2])
    check_and_time(hp, torch.float32, 2e-6, kernels.fused_collision_value_jac_multi,
                   (hp.A, hp.dpos, hp.dneg, c, dc), True,
                   kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5), wide_name, timed=True)
    del planner, prob, hp, c, dc
    torch.cuda.empty_cache()

    # small random banks: a short time axis (T=32, staged like the main shapes)
    # and a slab whose rows are not 16-byte aligned (O*T = 99: the direct path
    # inside the kernel), the second with 9 starts (two launches)
    small = {}
    for label, (Bs, Ss, L, O, T) in (("staged_T32", (4, 4, 7, 8, 32)), ("direct_O3_T33", (4, 9, 7, 3, 33))):
        gen = torch.Generator(device=dev).manual_seed(11)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

        A = randn(Bs, 36, 3, L, O, T)
        A = (A / A.norm(dim=2, keepdim=True)).to(torch.bfloat16)
        hp = BufferedHyperplanes(A, randn(Bs, 36, L, O, T), randn(Bs, 36, L, O, T),
                                 torch.ones((Bs, O), dtype=torch.bool, device=dev))
        c, dc = randn(Bs, Ss, 3, L, T), randn(Bs, Ss, n, 3, L, T)
        uniq = kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5)
        check_and_time(hp, torch.float32, 2e-6, kernels.fused_collision_value_jac_multi,
                       (hp.A, hp.dpos, hp.dneg, c, dc), True, uniq, f"value_jac_multi[{label}]",
                       timed=False, table=small)
        check_and_time(hp, torch.float32, 2e-6, kernels.fused_collision_values_multi,
                       (hp.A, hp.dpos, hp.dneg, c), False, uniq, f"values_multi[{label}]",
                       timed=False, table=small)
    del hp, A, c, dc, uniq

    rows["fused_collision_value_jac_multi"]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[many_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[wide_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows["fused_collision_values_multi"]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows[pool_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows["fused_collision_value_jac"]["replaces"] = "armour_tpu/collision/pallas_kernel.py:85"

    # ---- 4. main path ----------------------------------------------------
    planner = ArmourPlanner(spec, cfg, dtype=torch.float32, device=dev)
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
    main_name = "fused_collision_value_jac_multi"

    def run_point(probs, label, reps=2):
        args = (probs.q0, probs.qd0, probs.qdd0, probs.q_des, probs.zonos, probs.masks)
        planner.plan_batch(*args)                               # warm-up
        torch.cuda.synchronize()
        secs, deltas, res = [], [], None
        for _ in range(reps):
            kernels.reset_launch_counts()
            dt, res = wall(torch, lambda: planner.plan_batch(*args), 1)
            deltas.append(kernels.launch_counts())
            secs.append(dt)
        for d in deltas:
            assert d[main_name] == passes, f"{label}: {d} launches, expected {passes}"
        t_build, prob = wall(torch, lambda: planner.build_probs(*args[:3], *args[4:]), 1)
        t_solve, _ = wall(torch, lambda: planner.solve(prob, probs.q_des), 1)
        feas = res.feasible.cpu().numpy()
        k = res.k.cpu().numpy()
        assert np.all(np.isfinite(k[feas])) and np.all(np.isnan(k[~feas]))
        assert np.all(np.abs(k[feas]) <= 1.0)
        sec = statistics.median(secs)
        emit({"phase": "main_path", "point": label, "batch": B,
              "T": cfg.num_time_steps, "seconds_per_batch": sec, "seconds_runs": secs,
              "plans_per_s": B / sec, "feasible_fraction": float(feas.mean()),
              "bucket": int(prob.hp.dpos.shape[-2]), "launches_per_plan_batch": deltas[-1],
              "build_s": t_build, "solve_s": t_solve,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        return res, prob, deltas[-1]

    torch.cuda.reset_peak_memory_stats()
    res8, prob8, counts8 = run_point(probs8, "8obs")
    for r in rows.values():
        r["launches"] = counts8[r["wrapper"]]
    # one timed repetition here and three latency runs below: the modes,
    # the closed loop and the episodes further down take the time these
    # repetitions gave up
    _, _, counts40 = run_point(probs40, "40obs", reps=1)
    rows[wide_name]["launches"] = counts40[main_name]

    q0_0 = probs8.q0[0]
    obs1 = ObstacleSet(probs8.zonos[0], probs8.masks[0])
    lat, _ = wall(torch, lambda: planner.plan(q0_0, np.zeros(7), np.zeros(7), q0_0 + 0.05, obs1), 1)
    lats = [wall(torch, lambda i=i: planner.plan(probs8.q0[i], np.zeros(7), np.zeros(7),
                                                 probs8.q0[i] + 0.05, obs1), 1)[0]
            for i in range(3)]
    emit({"phase": "latency_batch1", "median_ms": statistics.median(lats) * 1e3,
          "runs_ms": [x * 1e3 for x in lats]})

    # the collision check of the returned plans: the user-level check path,
    # through the value-only and single-start kernels
    kernels.reset_launch_counts()
    feas = res8.feasible
    k_chk = torch.where(feas[:, None], res8.k, 0.0)
    centers, _, dcenters = prob8.links.slice_with_jac_multi(k_chk[:, None])
    g_multi = collision_values_multi(prob8.hp, centers)                       # (B,1,L,O,T)
    g_one, _ = collision_constraints_with_jac(prob8.hp, centers[:, 0], dcenters[:, 0])
    torch.cuda.synchronize()
    check_counts = kernels.launch_counts()
    worst = g_multi.flatten(1).amax(1)
    assert torch.equal(g_multi[:, 0], g_one), "the two check kernels disagree"
    assert bool((worst[feas] <= cfg.collision_violation_threshold).all()), \
        "a plan reported feasible violates the collision constraint"
    for name in ("fused_collision_values_multi", "fused_collision_value_jac"):
        assert check_counts[name] == 1, check_counts
        rows[name]["launches"] = check_counts[name]
    del centers, dcenters, g_multi, g_one
    emit({"phase": "check_path", "launches": check_counts,
          "max_collision_value_feasible": float(worst[feas].max()) if bool(feas.any()) else None,
          "feasible": int(feas.sum())})


    # ---- 5. the other planner modes at full width --------------------------
    zero_counts = {k.__name__: 0 for k in kernels.KERNELS}

    def hard_max_check(pl, prob, res, label):
        """Every plan reported feasible passes the hard-max collision check
        through the values-only kernel; k is finite and in the box where
        feasible, NaN where not."""
        feas = res.feasible
        k = res.k.cpu().numpy()
        f_np = feas.cpu().numpy()
        assert np.all(np.isfinite(k[f_np])) and np.all(np.isnan(k[~f_np])), label
        assert np.all(np.abs(k[f_np]) <= 1.0), label
        k_chk = torch.where(feas[:, None], res.k, 0.0)
        centers = prob.links.slice_with_jac_multi(k_chk[:, None])[0]
        worst = collision_values_multi(prob.hp, centers).flatten(1).amax(1)
        assert bool((worst[feas] <= pl.cfg.collision_violation_threshold).all()), \
            f"{label}: a plan reported feasible violates the hard-max collision constraint"
        return float(worst[feas].max()) if bool(feas.any()) else None

    def run_mode(label, pl, args, expect):
        pl.plan_batch(*args)                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        sec, res = wall(torch, lambda: pl.plan_batch(*args), 1)
        counts = kernels.launch_counts()
        assert counts == dict(zero_counts, **expect), f"{label}: launches {counts}, expected {expect}"
        peak = torch.cuda.max_memory_allocated() / 1e9
        prob = pl.build_probs(*args[:3], *args[4:])
        worst = hard_max_check(pl, prob, res, label)
        out = {"phase": "modes", "mode": label, "batch": B, "T": pl.cfg.num_time_steps,
               "seconds_per_batch": sec, "plans_per_s": B / sec,
               "feasible_fraction": float(res.feasible.float().mean()),
               "bucket": int(prob.hp.dpos.shape[-2]), "launches_per_plan_batch": counts,
               "max_collision_value_feasible": worst, "peak_mem_gb": peak}
        return res, prob, out

    args8 = (probs8.q0, probs8.qd0, probs8.qdd0, probs8.q_des, probs8.zonos, probs8.masks)
    _, _, out = run_mode("orig", ArmourPlanner(spec, cfg, dtype=torch.float32, device=dev,
                                               traj_type="orig"), args8, {main_name: passes})
    emit(out)

    # more starts than one launch of the main kernel takes (12: chunks of 8
    # and 4) through the same entry point: two launches per pass
    _, _, out = run_mode(f"{S_many}starts",
                         ArmourPlanner(spec, dataclasses.replace(cfg, nlp_num_starts=S_many),
                                       dtype=torch.float32, device=dev), args8, {main_name: 2 * passes})
    assert out["feasible_fraction"] > 0.0, out
    rows[many_name]["launches"] = out["launches_per_plan_batch"][main_name]
    emit(out)

    tau = 1e-3
    smooth_pl = ArmourPlanner(spec, dataclasses.replace(cfg, smooth_collision_tau=tau),
                              dtype=torch.float32, device=dev)
    _, _, out = run_mode("smooth", smooth_pl, args8, {"fused_collision_values_multi": 1})
    rows[pool_name]["launches"] = out["launches_per_plan_batch"]["fused_collision_values_multi"]
    emit(dict(out, tau=tau, pool=S_pool))
    del smooth_pl

    # grasp: every world starts near the tray-up pose (end-effector z-axis
    # up) at rest, with one far obstacle; the random poses of the problem
    # set hold the tray sideways, where the contact constraints cannot hold
    grasp = GraspConfig(object_mass=0.2, u_s=0.6, surf_rad=0.03)
    grasp_pl = ArmourPlanner(spec, cfg, dtype=torch.float32, device=dev, grasp=grasp)
    q_tray = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])
    q0_g = q_tray + np.random.default_rng(0).uniform(-0.05, 0.05, (B, n))
    far = ObstacleSet.from_boxes([[5.0, 5.0, 5.0]], [[0.1, 0.1, 0.1]], cfg.max_obstacles)
    zonos_g, masks_g = np.tile(far.zonos, (B, 1, 1, 1)), np.tile(far.mask, (B, 1))
    zeros = np.zeros((B, n))
    args_g = (q0_g, zeros, zeros, q0_g + 0.3 * cfg.k_range, zonos_g, masks_g)
    res_g, prob_g, out = run_mode("grasp", grasp_pl, args_g, {main_name: passes})
    feas_g = res_g.feasible
    assert bool(feas_g.any()), "grasp: no world is feasible at the tray-up pose"
    # sliced at the solver's own shape (B, S, n), so that a value the solver
    # accepted at the threshold is not re-rounded by another product shape
    k_rep = torch.where(feas_g[:, None], res_g.k, 0.0)[:, None].expand(B, S, n).contiguous()
    gc, gr, _ = prob_g.grasp.slice_with_jac_multi(k_rep)
    grasp_worst = (gc + gr[:, None])[:, 0].flatten(1).amax(1)[feas_g].max().item()
    assert grasp_worst <= 1e-6, f"grasp block at the returned k: {grasp_worst}"
    home = grasp_pl.plan(np.array(Q_HOME), np.zeros(n), np.zeros(n),
                         np.array(Q_HOME) + 0.3 * cfg.k_range, far)
    assert not bool(home.feasible), "grasp: the sideways tray of the home pose must be infeasible"
    emit(dict(out, max_grasp_value_feasible=grasp_worst, home_pose_feasible=bool(home.feasible)))
    del grasp_pl, res_g, prob_g, gc, gr
    torch.cuda.empty_cache()

    # ---- 6. plan and track: the closed loop on the 128 plans of phase 4 ---
    # 200 RK4 steps (0.1 s of the move): the battery below runs the whole
    # 1,000-step move, at B=100, and times it
    sim = dataclasses.replace(SimConfig(), t_move=200 * SimConfig().plant_dt)
    n_steps = int(round(sim.t_move / sim.plant_dt))
    rng_true = np.random.default_rng(0)
    true = TrueParams(rng_true.uniform(*sim.uncertain_mass_range, (B, spec.n_joints)),
                      rng_true.uniform(*sim.uncertain_mass_range, (B, spec.n_joints)))
    feas8 = res8.feasible
    k8 = torch.where(feas8[:, None], res8.k, 0.0).double().cpu().numpy()   # infeasible: k = 0 brakes
    traj = TrajParams(probs8.q0, probs8.qd0, probs8.qdd0, cfg.k_range * k8, np.zeros(B))
    track_kw = dict(duration=cfg.duration, controller="robust", device=dev, dtype=torch.float32)
    warm = dataclasses.replace(sim, t_move=10 * sim.plant_dt)
    rollout(spec, warm, probs8.q0, probs8.qd0, traj, true, **track_kw)      # warm-up, 10 steps
    t_roll, (q_end, qd_end, log) = wall(
        torch, lambda: rollout(spec, sim, probs8.q0, probs8.qd0, traj, true, **track_kw), 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_traced, _ = wall(torch, lambda: rollout(spec, warm, probs8.q0, probs8.qd0, traj, true,
                                                  **track_kw), 1)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.device_time for e in dev_events) * 1e-6
    # host-side calls per step: a 20-step rollout against a 10-step one
    warm20 = dataclasses.replace(sim, t_move=20 * sim.plant_dt)
    calls = [count_tensor_calls(lambda s=s: rollout(spec, s, probs8.q0, probs8.qd0, traj, true, **track_kw))
             for s in (warm, warm20)]
    assert dev_events, "the profiler recorded no device activity"
    pos_err = (log.q - log.q_ref).abs().amax(dim=(1, 2))                    # (B,)
    vel_err = (log.qd - log.qd_ref).abs().amax(dim=(1, 2))
    assert bool(torch.isfinite(log.q).all()) and bool(torch.isfinite(log.u).all())
    assert log.q.shape == (B, int(round(sim.t_move / sim.check_dt)), n), log.q.shape
    assert float(pos_err.max()) <= spec.qe, f"track: position error {float(pos_err.max())} > {spec.qe}"
    assert float(vel_err.max()) <= 2 * spec.ultimate_bound, f"track: velocity error {float(vel_err.max())}"
    n_log = log.q.shape[1]
    obs_log = ObstacleSet(
        torch.as_tensor(probs8.zonos, dtype=torch.float32, device=dev)[:, None].expand(-1, n_log, -1, -1, -1),
        torch.as_tensor(probs8.masks, device=dev)[:, None].expand(-1, n_log, -1))
    hits = arm_collision_check(spec, log.q, obs_log).any(dim=1)             # (B,)
    assert not bool(hits[feas8].any()), "track: a feasible world's executed motion hits an obstacle"
    emit({"phase": "track", "batch": B, "steps": n_steps, "plant_dt": sim.plant_dt,
          "controller": "robust", "dtype": "float32", "seconds_per_rollout": t_roll,
          "ms_per_rk4_step": t_roll / n_steps * 1e3,
          "kernel_launches_per_step": len(dev_events) / 10,
          "host_tensor_calls_per_step": (calls[1] - calls[0]) / 10,
          "traced_10_steps": {"wall_s": t_traced, "device_busy_s": busy_s,
                              "device_idle_share": 1.0 - busy_s / t_traced},
          "max_pos_err": float(pos_err.max()), "qe": spec.qe,
          "max_vel_err": float(vel_err.max()), "vel_bound": 2 * spec.ultimate_bound,
          "feasible_worlds": int(feas8.sum()), "collisions_feasible": int(hits[feas8].sum()),
          "collisions_infeasible_k0": int(hits[~feas8].sum())})
    del log, obs_log, prof, dev_events

    # ---- 7. card against CPU on the same paths ---------------------------
    cfg32 = dataclasses.replace(cfg, num_time_steps=32)
    probs4 = problem_set(cfg32, 4, n_obs=8, seed=0, device=dev)
    k_rand = np.random.default_rng(2).uniform(-0.6, 0.6, (4, max(S - 2, 1), n))
    gpu_pl = ArmourPlanner(spec, cfg32, dtype=torch.float64, device=dev)
    cpu_pl = ArmourPlanner(spec, cfg32, dtype=torch.float64, device="cpu")
    diffs, same = [], []
    kernels.reset_launch_counts()
    for i in range(4):
        obs = ObstacleSet(probs4.zonos[i], probs4.masks[i])
        args = (probs4.q0[i], probs4.qd0[i], probs4.qdd0[i], probs4.q_des[i], obs)
        rg = gpu_pl.plan(*args, k_rand=k_rand[i])
        rc = cpu_pl.plan(*args, k_rand=k_rand[i])
        fg, fc = bool(rg.feasible), bool(rc.feasible)
        same.append(fg == fc)
        kg, kc = rg.k.cpu().numpy(), rc.k.numpy()
        diffs.append(float(np.abs(kg - kc).max()) if fg and fc else 0.0)
        assert fg == fc, f"world {i}: card feasible={fg}, CPU feasible={fc}"
        assert fg or (np.isnan(kg).all() and np.isnan(kc).all())
        assert diffs[-1] <= 1e-6, f"world {i}: |k_card - k_cpu| = {diffs[-1]}"
    card_launches = kernels.launch_counts()[main_name]
    assert card_launches == 4 * passes, card_launches
    emit({"phase": "card_vs_cpu", "worlds": 4, "T": 32, "dtype": "float64",
          "feasible_equal": all(same), "max_abs_k_diff": max(diffs), "atol": 1e-6,
          "card_kernel_launches": card_launches})

    # one world for each of the other modes, and a short closed loop
    obs0 = ObstacleSet(probs4.zonos[0], probs4.masks[0])
    world0 = (probs4.q0[0], probs4.qd0[0], probs4.qdd0[0], probs4.q_des[0], obs0)
    tray = (q_tray, np.zeros(n), np.zeros(n), q_tray + 0.3 * cfg.k_range, far)
    mode_cases = (
        ("orig", dict(traj_type="orig"), cfg32, world0),
        ("smooth", {}, dataclasses.replace(cfg32, smooth_collision_tau=tau), world0),
        ("grasp", dict(grasp=grasp), cfg32, tray),
    )
    for label, kw, c32, world in mode_cases:
        rg = ArmourPlanner(spec, c32, dtype=torch.float64, device=dev, **kw).plan(*world, k_rand=k_rand[0])
        rc = ArmourPlanner(spec, c32, dtype=torch.float64, device="cpu", **kw).plan(*world, k_rand=k_rand[0])
        fg, fc = bool(rg.feasible), bool(rc.feasible)
        assert fg == fc, f"{label}: card feasible={fg}, CPU feasible={fc}"
        kg, kc = rg.k.cpu().numpy(), rc.k.numpy()
        diff = float(np.abs(kg - kc).max()) if fg else 0.0
        assert fg or (np.isnan(kg).all() and np.isnan(kc).all())
        assert diff <= 1e-6, f"{label}: |k_card - k_cpu| = {diff}"
        emit({"phase": "card_vs_cpu", "mode": label, "T": 32, "dtype": "float64",
              "feasible": fg, "max_abs_k_diff": diff, "atol": 1e-6})
    sim20 = dataclasses.replace(sim, t_move=20 * sim.plant_dt)
    traj4 = TrajParams(probs4.q0, probs4.qd0, probs4.qdd0,
                       cfg.k_range * np.random.default_rng(4).uniform(-1.0, 1.0, (4, n)), np.zeros(4))
    true4 = TrueParams(true.mass_scale[:4], true.inertia_scale[:4])
    ends = [rollout(spec, sim20, probs4.q0, probs4.qd0, traj4, true4, duration=cfg.duration,
                    device=d, dtype=torch.float64)[0].cpu() for d in (dev, "cpu")]
    end_diff = float((ends[0] - ends[1]).abs().max())
    assert end_diff <= 1e-9, f"rollout: |q_end card - q_end CPU| = {end_diff}"
    emit({"phase": "card_vs_cpu", "path": "rollout", "worlds": 4, "steps": 20,
          "dtype": "float64", "max_abs_q_end_diff": end_diff, "atol": 1e-9})

    # ---- 8-11. the receding-horizon episode paths --------------------------
    del res8, prob8, probs40
    torch.cuda.empty_cache()
    battery_row = episode_phases(torch, dev, check_and_time, rows, out_dir)

    # ---- tail ------------------------------------------------------------
    order = ("fused_collision_value_jac_multi", "fused_collision_values_multi",
             "fused_collision_value_jac", pool_name, many_name, wide_name, battery_row)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = []
    for name in order:
        r = dict(rows[name], max_abs_err=rows[name]["max_abs_err_float32"])
        table.append({k: r[k] for k in keys})
    with open(os.path.join(out_dir, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows, "small_banks": small, "ptxas": ptxas}, f, indent=1)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
