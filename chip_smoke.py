#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the ARMOUR planner on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. device   card name and power limit, torch/CUDA versions, TF32 flags
  2. build    nvcc builds of armour_tpu_torch/csrc/collision_bank.cu and
              csrc/rollout.cu and the g++ build of the mesh oracle, all at
              once; fails if ptxas reports a spill in any instantiation
  3. kernels  each of the three collision kernels against its plain PyTorch
              version on a bank built by the planner's own main path
              (seed 0, B=128, T=128, bucket 8, bf16 A; then an f64 bank),
              with CUDA-event times, bytes moved and the memory/compute bound;
              and, for every timed row, the device time of 20 calls
              replayed from one CUDA graph; the values-only kernel also at
              the 10 candidates of the smooth-mode verification pool and at
              the 26 of a 12-start plan's pool (two groups of 13 side by
              side in one block, held to the bit against launches at its
              first 16 and last 10 starts), the value + Jacobian kernel
              also at 12 starts (one launch of three start groups, held to the
              bit against launches at 8 and at 4 starts) and on the
              40-obstacle bank (bucket 16); then small random banks at T=32
              (staged path) and at a slab whose rows are not 16-byte aligned
              (direct path, 9 starts: one launch).  Every check also runs both
              launch paths (streaming and small-grid, where the bank's rows
              allow the small-grid one) and holds them to the wrapper's
              output bit for bit; every timed row names the path its launch
              reported and carries the graph time of an empty kernel
              (launch_floor) beside its bound, and each streaming row its
              grid (start groups, groups a block, blocks)
 3b. rollout_kernel
              the rollout kernel (csrc/rollout.cu: the whole move in one
              launch, one block of eight warps per world) against
              rollout_plain on the same inputs and noise, B=128, 200 steps:
              five controllers x bernstein/orig x f32/f64 and the planar 2-
              and 6-link arms, one launch each, the safety flags equal; then
              the battery's move (robust, f32, 1,000 steps) timed with CUDA
              events beside the plain version's graph, with its bounds
              (operations, and the chain of dependent operations); the same
              move at B=128 and 100 in f32 and f64 (f64 at B=128 also held
              to the plain version), with each instantiation's registers,
              spills and shared memory from the build
  4. main     ArmourPlanner.plan_batch at B=128, T=128, 8 obstacles: time,
              feasibility and kernel launches per plan; then the 40-obstacle
              point; then latency_batch1: plan() through its program kept
              per obstacle bucket (the build graph and the solver's inner
              graph kept), first call and 5 replays
              held to the eager plan to the bit with 65 launches each, the
              bucket sequence 8 -> 16 -> 8 through the cache, the main
              kernel on the batch-1 bank, and the collision check of a
              batch-1 plan (values_multi and single-start value_jac on the
              batch-1 bank, one launch each, small-grid path); then the
              collision check of the returned plans (values_multi and
              single-start value_jac)
  5. modes    one plan_batch at the same width for traj_type="orig", with
              12 starts (one launch per pass), for smooth collision (tau =
              1e-3; also at 12 starts, a pool of 26: one launch) and with
              grasp constraints
  6. track    the closed-loop move of the 128 plans of phase 4: robust
              controller, RK4 plant at 5e-4 s, 1,000 steps, all worlds at once,
              ONE launch of the rollout kernel: ms per move, device idle share;
              then the same move kept as one graph (packing and launch, a
              KeptFunction as the battery keeps it): equal to the bare move
              to the bit, one launch per call, ms and idle share
  7. parity   plan() on the card against plan() on the CPU (4 worlds, then
              one world per mode) and a 20-step rollout (the kernel against
              the CPU's plain version), T=32, f64
  8. self_intersection
              ArmourPlanner(self_intersection=True) and rotatotope_planner
              (orig + SI) at B=128, T=128 on the 8obs worlds, then
              ArmourPlanner(self_intersection=True) on 128 worlds at rest
              around Q_SI, where the SI block is near active: plans/s,
              feasible fraction, pairs and pruned pairs, 65 launches, the
              worst SI value of the feasible plans <= the collision threshold
              (some plan must be feasible, except Bernstein + SI on the 8obs
              worlds, where pair (3, 6) rules out every plan);
              then rotatotope_planner on the planar 2- and 6-link arms (worlds
              from numpy seed 0 inside their reach); the main kernel against
              its plain version on each planar bank
  9. parity   SI plans on the card against the CPU: ArmourPlanner with
              self_intersection and rotatotope_planner, 6 worlds at rest
              around Q_SI each, T=32, f64; some plan of each must be feasible
10. scale_out
              sharded_plan_step on an in-process NCCL group of one rank, mesh
              (1, 1), kept per (B, shard capacity) as the planner's full-width
              plan program: its first call (captures) and 5 replays, each
              equal to step(eager=True) to the bit in every field with equal
              launches, and k within 1e-6 of plan_batch on the 8obs worlds'
              8 slots; then the local bank pass of a cp = 2 rank (4 of 8
              slots, 20 of 40) through the same step, a program each (first
              call and a replay), 0 evictions, with the main kernel against
              its plain version there
10b. guidance
              the guidance's kept programs (the JAX package's compiled helpers
              of the battery's host guidance) against the same functions op
              by op, at the battery's shapes: the end-effector positions
              (ee) and the IK (ik) of the 100 worlds of assets/worlds in f32,
              the mesh refinement's FK of 50-step windows at every row bucket
              (1, 2, 4, ..., 64, 100), the one-row f64 IK of the
              configuration waypoints and ee_rrt_star_config_waypoints
              itself, and optimization_waypoint (f64, 40 slots): each equal
              to op by op to the bit on its first call and on its replays;
              ms per call kept and op by op, capture ms, and the captures,
              hits and evictions of a stage cache sized as the battery sizes
              its own (and of the module's cache of hlp.py)
11. battery  run_batch_stepped over the 100 worlds of assets/worlds at
              B=100, T=128, f32, 2 iterations, mesh oracle: one JSON line per
              iteration (wall split, buckets, launches = 65 and one rollout
              kernel launch, mesh hits), the summary with the mean split,
              each iteration's roll_and_check_s and the kept stages' captures,
              hits (by stage too: ee, ik, fk), misses and evictions; fails on
              any safety violation.  The main
              kernel is held against its plain version on the battery's
              first bank
12. hard     the doorway scene with up-front RRT-connect guidance, 2
              iterations
13. episode  EpisodeRunner.run_batch on 4 worlds and run_recorded_episode on
              one (save/load round trip), 1 iteration each; then run_batch at
              full width (B=128, T=128, f32, the 8obs worlds with goals
              0.3-0.6 rad away, 5 iterations) through its kept episode program
              and with eager=True: every summary field equal to the bit, 65
              main-kernel launches and one rollout launch per iteration, the
              per-iteration wall, capture ms, program hits and misses and
              memory_allocated of each; then the same worlds with each goal
              at its start (every world ends before max_iterations=4), two
              calls on one generator, kept and eager=True: summaries equal
              to the bit, the kept loop one iteration (65 + 1 launches) past
              the last end, and the generator's state equal after each call
14. parity   run_batch_stepped on the card against the CPU: 2 worlds, T=32,
              f64, 2 iterations, the same injected draws; every summary field
              equal
15. reference_schema
              export_reference_schema.export at T=128, 20 samples per
              interval, f64 and f32, into chiprun_out/reference_schema{,_f32}/:
              every number of the .out files (the build time aside) within the
              printed digits of results/reference_schema{,_f32}/, 0 containment
              violations, the minimum margins to 1e-9 (f64) and 1e-5 (f32);
              then the offline-set slicing on a synthetic set, card against CPU
16. figures  constraint_traces over the 89 replans of
              assets/figures/scenario3_recording.npz, T=128, f32: one launch
              of the values-only kernel, the rebuilt torque radii equal to the
              recorded ones (rtol 1e-5), feasible replans within the
              thresholds, card against CPU to 1e-5; every figure function once
              (None where matplotlib is missing); the kernel against its plain
              version at that batch
17. grasp_example
              grasp_example.main on the card: a feasible grasp plan, 65 main
              kernel launches per plan; the kernel at the example's shape
18. graphs   the CUDA graphs of the solver iteration (every phase above runs
              them) and of rollout_plain's RK4 step against the same steps run op by
              op: plan_batch at B=128, T=128 on 8obs, 40obs, orig, 12 starts,
              smooth, grasp, Bernstein + SI (near_si) and rotatotope, and two
              world sets in a row, equal to the bit with the launches of the
              eager run (batch-1 plans: phase 4); 200-step rollouts of the five
              controllers in f32 and f64, equal to the bit; both times and
              the capture ms
19. controller_sweep
              compare_controllers.main (16 trajectories, 6 uncertainty levels,
              5 controllers, 1,000 steps): every within_ultimate_bound flag
              equal to results/r4_controller_sweep.json's, every error within
              SWEEP_RTOL of it
20. simple_example
              simple_example.main: the two-box episode at T=64, up to 30
              iterations; goal reached, no collision, 65 launches per plan
21. armtd_comparison
              run_armtd_comparison.main over assets/worlds, 2 iterations per
              half: the JSON keys of results/r4_armtd_vs_armour.json (plus
              device and protocol), 0 collisions, each half's launches
22. bench_scaling
              bench_scaling.main --production: the one-card NCCL row, its keys
              those of results/r5_scaling_virtual8.json's rows
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


# a Kinova pose whose self-intersection block is near active (its worst pair
# value is about -0.03 at k = 0)
Q_SI = (0.0, 0.5, 0.0, -0.5, 0.0, 0.5, 0.0)
SAFETY = ("collision", "torque_violation", "joint_limit_violation", "ultimate_bound_violation")
SUMMARY_FIELDS = ("goal_reached", *SAFETY, "stopped", "iterations", "n_feasible_plans")
# the controller sweep's rows against results/r4_controller_sweep.json, the
# tolerance tests/test_torch_compare_controllers.py states
SWEEP_RTOL = 1e-2


def guidance_phase(torch, dev, n_worlds=100, reps=5):
    """Phase 10b: each kept program of the host guidance against the same
    function op by op, at the battery's shapes (see the module's docstring).
    ``n_worlds`` and ``reps`` exist to rehearse the phase on the CPU, where
    a kept program runs op by op through its buffers."""
    from armour_tpu_torch.collision.zonotope import ObstacleSet
    from armour_tpu_torch.config import PlannerConfig, SimConfig
    from armour_tpu_torch.dynamics.utility import ee_pose
    from armour_tpu_torch.planner import hlp
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim import harness
    from armour_tpu_torch.sim.scenarios import load_world_csv, stack_worlds
    from armour_tpu_torch.utils.graphs import CapturedStep, KeptFunction, ProgramCache

    spec, cfg, sim = kinova_gen3_spec(), PlannerConfig(), SimConfig()
    f32, f64 = torch.float32, torch.float64
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn, n=reps):
        """Median host ms of fn() ending in a synchronise, and its output."""
        times, out = [], None
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out

    as_bits = {f32: torch.int32, f64: torch.int64}

    def same(a, b):
        """Equal to the bit (tensors as bit patterns, NaN where both are)."""
        if isinstance(a, torch.Tensor):
            return a.dtype == b.dtype and torch.equal(
                *(x.cpu().view(as_bits[x.dtype]) if x.dtype in as_bits else x.cpu() for x in (a, b)))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        if isinstance(a, tuple):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    def capture_ms(prog):
        return prog.step.capture_ms if isinstance(prog.step, CapturedStep) else None

    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, "assets", "worlds", "*.csv")))[:n_worlds]
    worlds = [load_world_csv(f, cfg.max_obstacles, f32, device=dev) for f in files]
    starts, goals, zonos, masks = stack_worlds(worlds, f32)
    B = starts.shape[0]
    # a stage cache of the size the battery driver gives its own
    cache = ProgramCache(len(harness.STAGES) + (B - 1).bit_length() + 1)
    programs = {}

    def kept_against_eager(name, fn, *args):
        eager_ms, ref = timed(lambda: fn(*args), max(reps - 2, 1))
        key = (name, *(tuple(x.shape) for x in args))

        def run():
            return cache.run(key, lambda: KeptFunction(fn, dev), *args)

        first_ms, first = timed(run, 1)
        equal = [same(first, ref)]
        kept_ms, out = timed(run)
        equal.append(same(out, ref))
        assert all(equal), f"guidance: kept {name} differs from op by op {equal}"
        programs[name] = {"equal_to_eager": True, "kept_ms": kept_ms, "eager_ms": eager_ms,
                          "first_call_ms": first_ms, "capture_ms": capture_ms(cache.entries[key])}

    # the battery's ee and ik stages: every world's end effector, then the IK
    # to the end effector of its goal from halfway there
    kept_against_eager("ee", lambda q: (ee_pose(spec, q)[1],), starts)
    targets = ee_pose(spec, goals)[1]
    kept_against_eager("ik", lambda t, s: hlp.ik_to_position(spec, t, s), targets,
                       0.5 * (starts + goals))
    # the mesh refinement's FK at every row bucket, on windows of the check
    # length around each start
    n_chk = int(round(sim.t_move / sim.check_dt))
    rng = np.random.default_rng(12)
    log_q = starts[:, None] + torch.as_tensor(rng.uniform(-0.2, 0.2, (B, n_chk, 7)), dtype=f32,
                                              device=dev)
    buckets = sorted({harness.fk_rows(F, B) for F in range(1, B + 1)})
    for n in buckets:
        rows_n = torch.as_tensor(rng.permutation(B)[:n], device=dev)
        kept_against_eager(f"fk[{n}]", lambda lq, r: harness.windows_fk(spec, lq, r), log_q, rows_n)
    # the configuration waypoints' program: one row, f64
    kept_against_eager("ik[B=1,f64]", lambda t, s: hlp.ik_to_position(spec, t, s),
                       targets[:1].to(f64), (0.5 * (starts + goals))[:1].to(f64))
    stage_cache = cache.stats()
    cache.clear()

    # the entry points through the module's cache: the configuration
    # waypoints of the first world that has an EE RRT* path, and the
    # optimization waypoint of world 0
    hlp.PROGRAMS.clear()
    s_np, g_np = starts.double().cpu().numpy(), goals.double().cpu().numpy()
    z_np, m_np = zonos.double().cpu().numpy(), masks.cpu().numpy()
    entry = {}
    for w in range(min(B, 5)):
        obs_w = ObstacleSet(z_np[w], m_np[w])
        call = {}
        for eager in (False, True):
            call[eager] = timed(lambda: hlp.ee_rrt_star_config_waypoints(
                spec, s_np[w], g_np[w], obs_w, seed=w, device=dev, eager=eager), 1)
        if call[False][1] is None:
            continue
        assert same(call[False][1], call[True][1]), "guidance: kept configuration waypoints differ"
        entry["config_waypoints"] = {"world": os.path.basename(files[w]),
                                     "waypoints": len(call[False][1]), "equal_to_eager": True,
                                     "kept_ms": call[False][0], "eager_ms": call[True][0]}
        break
    assert "config_waypoints" in entry, "guidance: no EE RRT* path in the first worlds"
    obs0 = ObstacleSet(z_np[0], m_np[0])
    opt = {}
    for eager in (True, False, False):
        opt.setdefault(eager, []).append(timed(lambda: hlp.optimization_waypoint(
            spec, s_np[0], g_np[0], obs0, device=dev, eager=eager), 1))
    assert all(same(k[1], opt[True][0][1]) for k in opt[False]), "guidance: kept optimization waypoint differs"
    entry["optimization_waypoint"] = {"obstacle_slots": int(z_np.shape[1]), "equal_to_eager": True,
                                      "ok": bool(opt[True][0][1][1]), "eager_ms": opt[True][0][0],
                                      "first_call_ms": opt[False][0][0], "kept_ms": opt[False][1][0]}
    entry["capture_ms"] = {k[0]: capture_ms(p) for k, p in hlp.PROGRAMS.entries.items()}
    module_cache = hlp.PROGRAMS.stats()
    hlp.PROGRAMS.clear()
    emit({"phase": "guidance", "worlds": B, "dtype": "float32", "check_steps": n_chk,
          "fk_row_buckets": buckets, "programs": programs, **entry,
          "stage_cache": dict(stage_cache, capacity=cache.capacity), "hlp_cache": module_cache})


def episode_phases(torch, dev, check_and_time, rows, out_dir, n_worlds=100, T=128, sim_kw=None,
                   episode_worlds=128):
    """Phases 11-14, the receding-horizon episode paths: the 100-world battery,
    the doorway scene, the episode program (4 worlds, then ``episode_worlds``
    kept against eager) and the recorded episode, and the battery driver on
    the card against the CPU.  Every phase resets the launch counts just
    before it and reads them just after.  ``n_worlds``, ``T``, ``sim_kw``
    (SimConfig overrides) and ``episode_worlds`` exist to rehearse the
    phases at a small size on the CPU."""
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.collision.zonotope import kernel_layout
    from armour_tpu_torch.config import PlannerConfig, SimConfig
    from armour_tpu_torch.planner.armour import obstacle_bucket
    from armour_tpu_torch.problems import problem_set
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim import rollout_kernel as rk
    from armour_tpu_torch.sim.harness import (
        Draws,
        EpisodeRunner,
        TrueParams,
        generator_draws,
        run_batch_stepped,
    )
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

    # ---- 11. battery: the 100-world suite, as run_100_worlds loads it ----
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
        assert tr["rollout_launches"] == 1, tr["rollout_launches"]
    assert counts == dict(zero, **{main_name: passes * len(trace)}), counts
    summary = summarize_episodes(s)
    with open(os.path.join(out_dir, "battery_trace.json"), "w") as f:
        json.dump({"trace": trace, "summary": summary,
                   "worlds": [os.path.basename(x) for x in files]}, f, indent=1)
    emit({"phase": "battery", "worlds": B, "T": T, "dtype": "float32", "hlp": "straight",
          "collision_oracle": "mesh", "iterations": len(trace), "seconds": battery_s,
          "seconds_per_iteration": battery_s / max(len(trace), 1), "launches": counts,
          "rollout_launches": sum(tr["rollout_launches"] for tr in trace),
          "program_captures": [tr["program_captures"] for tr in trace],
          "program_hits": [tr["program_hits"] for tr in trace],
          "roll_and_check_s": [tr["roll_and_check_s"] for tr in trace],
          **{f"stage_{k}": [tr[f"stage_{k}"] for tr in trace]
             for k in ("captures", "hits", "misses", "evictions", "hits_by_name")},
          "ee_worlds": [tr["ee_worlds"] for tr in trace],
          "memory_allocated": [tr["memory_allocated"] for tr in trace],
          "split_mean_s": {k: statistics.mean(tr[k] for tr in trace) for k in
                           ("ref_waypoints_s", "build_probs_s", "solve_s", "roll_and_check_s",
                            "mesh_refine_s", "host_s", "wall_s")} if trace else {},
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

    # ---- 12. hard: the doorway with up-front configuration-space RRT-connect ----
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

    # ---- 13. episode: the episode program and the recorded episode ----
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

    # the episode program at full width: the 8obs worlds, goals 0.3-0.6 rad
    # from each start in every joint (no world reaches its goal in the run),
    # through the kept episode program and op by op
    p8 = problem_set(cfg, episode_worlds, n_obs=8, seed=0, device=dev)
    e_goals = p8.q0 + 0.3 * np.sign(p8.q_des - p8.q0) + 0.3 * (p8.q_des - p8.q0) / cfg.k_range
    n_it = 5
    full = {}
    for eager in (False, True):
        frun = EpisodeRunner(spec, cfg, SimConfig(max_iterations=n_it, **sim_kw), f32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        inner = generator_draws(frun.planner, frun.sim_cfg, episode_worlds, gen)
        stamps, mem = [], []

        def draws(i, inner=inner, stamps=stamps, mem=mem):
            stamps.append(time.perf_counter())
            mem.append(torch.cuda.memory_allocated() if torch.device(dev).type == "cuda" else None)
            return inner(i)

        sync()
        kernels.reset_launch_counts()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        s_f = frun.run_batch(p8.q0, e_goals, p8.zonos, p8.masks, gen, draws=draws, eager=eager)
        sync()
        t_end = time.perf_counter()
        launches = {main_name: kernels.launch_counts()[main_name],
                    "fused_rollout": rk.launch_counts()["fused_rollout"]}
        assert len(stamps) == n_it, f"episode: {len(stamps)} iterations run"
        assert launches == {main_name: passes * n_it, "fused_rollout": n_it}, launches
        iteration_s = np.diff(stamps + [t_end]).tolist()
        full[eager] = {"summary": s_f, "seconds": t_end - t0, "iteration_s": iteration_s,
                       "median_iteration_s": statistics.median(iteration_s[1:]),
                       "launches": launches, "memory_allocated": mem,
                       "episode_programs": frun.programs.stats(),
                       "plan_programs": frun.planner.batch_programs.stats()}
        del frun
    for name in SUMMARY_FIELDS:
        a, b = getattr(full[False]["summary"], name), getattr(full[True]["summary"], name)
        assert torch.equal(a, b), f"episode: {name} kept {a.tolist()} eager {b.tolist()}"
    s_f = full[False]["summary"]
    assert s_f.iterations.shape == (episode_worlds,) and int(s_f.iterations.max()) == n_it
    safe(s_f, "episode program at full width")
    emit({"phase": "episode", "path": "run_batch_full_width", "worlds": episode_worlds, "T": T,
          "dtype": "float32", "iterations": n_it, "equal_to_eager": True,
          **{label: {k: v for k, v in full[eager].items() if k != "summary"}
             for label, eager in (("kept", False), ("eager", True))},
          "n_feasible_plans": s_f.n_feasible_plans.sum().item(),
          "stopped": int(s_f.stopped.sum()), "goal_reached": int(s_f.goal_reached.sum())})

    # the same worlds with each goal at its start, so every world ends
    # before max_iterations: the kept loop reads the done flag one iteration
    # late (pinned memory and an event on the card), runs exactly one
    # iteration after the last world ended, and gives that iteration's
    # draws back; two calls on one generator, as run_worlds makes them
    max_it = 4
    early = {}
    for eager in (False, True):
        frun = EpisodeRunner(spec, cfg, SimConfig(max_iterations=max_it, **sim_kw), f32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        calls = []
        for _ in range(2):
            sync()
            kernels.reset_launch_counts()
            rk.reset_launch_counts()
            t0 = time.perf_counter()
            s_x = frun.run_batch(p8.q0, p8.q0, p8.zonos, p8.masks, gen, eager=eager)
            sync()
            calls.append({"summary": s_x, "seconds": time.perf_counter() - t0,
                          "launches": (kernels.launch_counts()[main_name],
                                       rk.launch_counts()["fused_rollout"]),
                          "generator": gen.get_state()})
        early[eager] = calls
        del frun
    ends = []
    for kept, eager in zip(early[False], early[True]):
        for name in SUMMARY_FIELDS:
            a, b = getattr(kept["summary"], name), getattr(eager["summary"], name)
            assert torch.equal(a, b), f"episode ending early: {name} kept {a.tolist()} eager {b.tolist()}"
        s_x = eager["summary"]
        assert bool((s_x.goal_reached | s_x.collision | s_x.stopped).all()), "episode: a world did not end"
        n = int(s_x.iterations.max())
        assert n < max_it, f"episode: the last world ended at iteration {n} of {max_it}"
        assert eager["launches"] == (passes * n, n), eager["launches"]
        assert kept["launches"] == (passes * (n + 1), n + 1), kept["launches"]
        assert torch.equal(kept["generator"], eager["generator"]), "episode: the generators differ"
        safe(s_x, "episode ending early")
        ends.append(n)
    emit({"phase": "episode", "path": "run_batch_ends_early", "worlds": episode_worlds,
          "max_iterations": max_it, "last_world_ended_at": ends, "equal_to_eager": True,
          "iterations_after_the_last_end": 1, "generator_equal": True,
          **{label: [{k: c[k] for k in ("seconds", "launches")} for c in early[eager]]
             for label, eager in (("kept", False), ("eager", True))}})

    # ---- 14. the battery driver on the card against the CPU ----
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


def planar_worlds(torch, spec, cfg, B, n_obs=8, seed=0, device="cuda"):
    """B worlds of a planar arm: q0 uniform in [-0.5, 0.5] per joint,
    q_des within one k_range of it, and ``n_obs`` boxes (half sides
    0.05-0.15 m) centred in the arm's plane at 0.3-1.0 of its reach,
    rejection-screened clear of the start pose, all from numpy ``seed``."""
    from armour_tpu_torch.collision.zonotope import ObstacleSet
    from armour_tpu_torch.sim.world import arm_collision_check

    rng = np.random.default_rng(seed)
    n = spec.n_factors
    q0 = rng.uniform(-0.5, 0.5, (B, n))
    q_des = q0 + rng.uniform(-1.0, 1.0, (B, n)) * cfg.k_range
    n_cand = 4 * n_obs
    reach = float(np.abs(spec.trans[1:, 0]).sum())
    r = rng.uniform(0.3, 1.0, (B, n_cand)) * reach
    th = rng.uniform(-np.pi, np.pi, (B, n_cand))
    cand = np.zeros((B, n_cand, 4, 3))
    cand[..., 0, 0], cand[..., 0, 1] = r * np.cos(th), r * np.sin(th)
    cand[..., 0, 2] = spec.trans[0, 2]
    half = rng.uniform(0.05, 0.15, (B, n_cand, 3))
    for i in range(3):
        cand[..., 1 + i, i] = half[..., i]
    q = torch.as_tensor(q0, dtype=torch.float32, device=device)[:, None].expand(B, n_cand, n)
    hits = arm_collision_check(spec, q, ObstacleSet(
        torch.as_tensor(cand[:, :, None], dtype=torch.float32, device=device),
        torch.ones((B, n_cand, 1), dtype=torch.bool, device=device))).cpu().numpy()
    zonos, masks = np.zeros((B, n_obs, 4, 3)), np.zeros((B, n_obs), bool)
    for b in range(B):
        keep = np.nonzero(~hits[b])[0][:n_obs]
        zonos[b, :keep.size], masks[b, :keep.size] = cand[b, keep], True
    zero = np.zeros((B, n))
    return q0, zero, zero, q_des, zonos, masks


def extension_phases(torch, dev, check_and_time, rows, probs8, probs40, T=128, T_parity=32,
                     n_parity=6):
    """Phases 8-10: the self-intersection planner (the Kinova with
    ``self_intersection=True`` and ``rotatotope_planner``, then the planar
    2- and 6-link arms), SI plans on the card against the CPU, and the
    scale-out step on a process group of one rank (NCCL on the card, gloo
    on the CPU).  Every path resets the launch counts just before it and
    reads them just after.  Returns the names of the kernel rows it added.
    ``dev``, ``T`` and the batch of ``probs8`` exist to rehearse the phases
    at a small size on the CPU."""
    import warnings

    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.collision.zonotope import ObstacleSet, collision_values_multi, kernel_layout
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.planner.rotatotope import rotatotope_planner, self_intersection_values_multi
    from armour_tpu_torch.problems import problem_set
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.robots.planar import planar_arm_spec

    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=T)
    B, n = probs8.q0.shape
    f32, f64 = torch.float32, torch.float64
    main_name = "fused_collision_value_jac_multi"
    zero = {k.__name__: 0 for k in kernels.KERNELS}
    on_card = torch.device(dev).type == "cuda"
    added = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def passes(pl):
        return pl.cfg.nlp_outer_iters * pl.cfg.nlp_inner_iters + 1

    def timed(label, pl, fn, warm=True):
        """fn() once after a warm-up call: (result, seconds, launches); the
        main kernel must launch once per constraint pass, nothing else."""
        if warm:
            fn()
        sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        sec = time.perf_counter() - t0
        counts = kernels.launch_counts()
        assert counts == dict(zero, **{main_name: passes(pl)}), f"{label}: launches {counts}"
        return res, sec, counts

    def worst_at_plans(pl, prob, res):
        """The worst self-intersection and collision values of the plans
        reported feasible, sliced at the solver's (B, S, n) shape so that a
        value accepted at the threshold is not re-rounded by another product
        shape; (None, None) where no plan is feasible."""
        feas = res.feasible
        if not bool(feas.any()):
            return None, None
        S = pl.cfg.nlp_num_starts
        k = torch.where(feas[:, None], res.k, 0.0)[:, None].expand(-1, S, -1).contiguous()
        centers = prob.links.slice_with_jac_multi(k)[0][:, :1].contiguous()
        col = collision_values_multi(prob.hp, centers).flatten(1).amax(1)
        if prob.si_diff is None:                     # no pair to check (planar 2)
            return None, float(col[feas].max())
        si = self_intersection_values_multi(prob.si_diff, prob.si_rad, k)[:, 0].flatten(1).amax(1)
        return float(si[feas].max()), float(col[feas].max())

    def kernel_row(name, pl, args, launches, seed):
        """The main kernel against its plain version on the bank that the
        planner ``pl`` builds from ``args`` without culling (f32, timed;
        then f64), noted in the table as ``name``."""
        for dtype, tol in ((f32, 2e-6), (f64, 1e-12)):
            p = dataclasses.replace(pl, dtype=dtype, device=dev)
            prob = p.build_probs(*args[:3], *args[4:], cull=False)
            hp = prob.hp
            nf = p.spec.n_factors
            K = torch.as_tensor(np.random.default_rng(seed).uniform(-0.9, 0.9, (B, p.cfg.nlp_num_starts, nf)),
                                dtype=dtype, device=dev)
            c, dc = kernel_layout(*prob.links.slice_with_jac_multi(K)[::2])
            check_and_time(hp, dtype, tol, kernels.fused_collision_value_jac_multi,
                           (hp.A, hp.dpos, hp.dneg, c, dc), True,
                           kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5), name,
                           timed=dtype == f32)
            del p, prob, hp, K, c, dc
        rows[name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
        rows[name]["launches"] = launches
        added.append(name)

    def near_si(cfg_, n_worlds):
        """``n_worlds`` Kinova worlds at rest around ``Q_SI`` (8 obstacles
        clear of the start pose), where the SI block is near active."""
        p = problem_set(cfg_, n_worlds, n_obs=8, seed=0, device=dev, q_center=Q_SI)
        rest = np.zeros_like(p.q0)
        return p._replace(qd0=rest, qdd0=rest)

    # ---- 8. self_intersection: the Kinova, then the planar arms ----------
    thr = cfg.collision_violation_threshold
    args8 = (probs8.q0, probs8.qd0, probs8.qdd0, probs8.q_des, probs8.zonos, probs8.masks)
    args_si = tuple(near_si(cfg, B))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the PRUNED warning; the pairs are reported below
        si_planners = {"bernstein+si": ArmourPlanner(spec, cfg, f32, device=dev, self_intersection=True),
                       "rotatotope": rotatotope_planner(spec, cfg, f32, device=dev)}
    # around Q_HOME every Bernstein plan breaks pair (3, 6), as in the JAX
    # package; every other run must give some feasible plan to check
    for label, worlds, args in (("bernstein+si", "8obs", args8), ("rotatotope", "8obs", args8),
                                ("bernstein+si", "near_si", args_si)):
        pl = si_planners[label]
        kinova_pairs = [tuple(p) for p in pl._si_pairs]
        pruned = [(i, j) for i in range(spec.n_joints) for j in range(i + 2, spec.n_joints)
                  if (i, j) not in kinova_pairs]
        res, sec, counts = timed(label, pl, lambda: pl.plan_batch(*args))
        prob = pl.build_probs(*args[:3], *args[4:])
        si_worst, col_worst = worst_at_plans(pl, prob, res)
        k = res.k.cpu().numpy()
        f_np = res.feasible.cpu().numpy()
        assert np.all(np.isfinite(k[f_np])) and np.all(np.isnan(k[~f_np])), label
        assert si_worst is not None or (label, worlds) == ("bernstein+si", "8obs"), \
            f"{label} on {worlds}: no feasible plan"
        assert si_worst is None or si_worst <= thr, f"{label}: a feasible plan's SI value {si_worst}"
        assert col_worst is None or col_worst <= thr, f"{label}: a feasible plan's collision value {col_worst}"
        emit({"phase": "self_intersection", "robot": "kinova", "mode": label, "worlds": worlds,
              "batch": B, "T": T, "dtype": "float32", "seconds_per_batch": sec, "plans_per_s": B / sec,
              "feasible_fraction": float(res.feasible.float().mean()), "pairs": len(kinova_pairs),
              "pair_list": kinova_pairs, "pruned_pairs": pruned, "launches_per_plan_batch": counts,
              "max_si_value_feasible": si_worst, "max_collision_value_feasible": col_worst,
              "threshold": thr})
        del res, prob
    del si_planners, pl, args_si
    for n_links in (2, 6):
        pspec = planar_arm_spec(n_links)
        pl = rotatotope_planner(pspec, cfg, f32, device=dev)
        pargs = planar_worlds(torch, pspec, cfg, B, device=dev)
        res, sec, counts = timed(f"planar{n_links}", pl, lambda: pl.plan_batch(*pargs))
        prob = pl.build_probs(*pargs[:3], *pargs[4:])
        si_worst, col_worst = worst_at_plans(pl, prob, res)
        assert si_worst is None or si_worst <= thr, f"planar{n_links}: SI value {si_worst}"
        assert col_worst is None or col_worst <= thr, f"planar{n_links}: collision value {col_worst}"
        emit({"phase": "self_intersection", "robot": f"planar{n_links}", "mode": "rotatotope",
              "batch": B, "T": T, "dtype": "float32", "seconds_per_batch": sec, "plans_per_s": B / sec,
              "feasible_fraction": float(res.feasible.float().mean()), "pairs": len(pl._si_pairs),
              "live_obstacles_per_world": float(pargs[5].sum(1).mean()),
              "bucket": int(prob.hp.dpos.shape[-2]), "launches_per_plan_batch": counts,
              "max_si_value_feasible": si_worst, "max_collision_value_feasible": col_worst})
        del res, prob
        kernel_row(f"{main_name}[planar{n_links}]", pl, pargs, counts[main_name], seed=20 + n_links)
        del pl
    if on_card:
        torch.cuda.empty_cache()

    # ---- 9. SI plans on the card against the CPU --------------------------
    cfgp = dataclasses.replace(cfg, num_time_steps=T_parity)
    probs4 = near_si(cfgp, n_parity)
    k_rand = np.random.default_rng(2).uniform(-0.6, 0.6, (n_parity, max(cfg.nlp_num_starts - 2, 1), n))
    for label in ("bernstein+si", "rotatotope"):
        planners = {d: (ArmourPlanner(spec, cfgp, f64, device=d, self_intersection=kinova_pairs)
                        if label == "bernstein+si" else
                        rotatotope_planner(spec, cfgp, f64, pairs=kinova_pairs, device=d))
                    for d in (dev, "cpu")}
        diffs, feas = [], []
        kernels.reset_launch_counts()
        for i in range(n_parity):
            obs = ObstacleSet(probs4.zonos[i], probs4.masks[i])
            a = (probs4.q0[i], probs4.qd0[i], probs4.qdd0[i], probs4.q_des[i], obs)
            rg, rc = (planners[d].plan(*a, k_rand=k_rand[i]) for d in (dev, "cpu"))
            fg, fc = bool(rg.feasible), bool(rc.feasible)
            assert fg == fc, f"{label} world {i}: card feasible={fg}, CPU feasible={fc}"
            kg, kc = rg.k.cpu().numpy(), rc.k.numpy()
            assert fg or (np.isnan(kg).all() and np.isnan(kc).all())
            diffs.append(float(np.abs(kg - kc).max()) if fg else 0.0)
            feas.append(fg)
            assert diffs[-1] <= 1e-6, f"{label} world {i}: |k_card - k_cpu| = {diffs[-1]}"
        assert any(feas), f"{label}: no feasible plan to compare"
        card_launches = kernels.launch_counts()[main_name]
        assert not on_card or card_launches == n_parity * passes(planners[dev]), card_launches
        emit({"phase": "card_vs_cpu", "mode": label, "worlds": n_parity, "T": T_parity,
              "dtype": "float64", "feasible": feas, "feasible_equal": True,
              "max_abs_k_diff": max(diffs), "atol": 1e-6, "card_kernel_launches": card_launches})
    del planners, probs4

    # ---- 10. scale_out: sharded_plan_step on a group of one rank ----------
    scale_out_phase(torch, dev, probs8, probs40, timed, kernel_row, T=T)
    return added


def scale_out_phase(torch, dev, probs8, probs40, timed, kernel_row, T=128):
    """Phase 10: the sharded step on an in-process process group of one
    rank (NCCL on the card, gloo on the CPU), kept per (B, shard capacity),
    against its eager run and ``plan_batch``; then a cp = 2 rank's shards
    through the same step.  ``timed(label, planner, fn, warm)`` and
    ``kernel_row(name, planner, args, launches, seed)`` are
    ``extension_phases``'s; ``dev``, ``T`` and the batch of ``probs8``
    exist to rehearse the phase at a small size on the CPU."""
    import socket

    import torch.distributed as dist

    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.parallel.mesh import cp_shard, make_planner_mesh, sharded_plan_step
    from armour_tpu_torch.parallel.multihost import gather_summary, init_distributed, scatter_worlds
    from armour_tpu_torch.planner.armour import ArmourPlanner, PlanProgram, gather_obstacles, obstacle_bucket
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.utils.graphs import CapturedStep

    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=T)
    B = probs8.q0.shape[0]
    f32, f64 = torch.float32, torch.float64
    main_name = "fused_collision_value_jac_multi"
    on_card = torch.device(dev).type == "cuda"
    args8 = (probs8.q0, probs8.qd0, probs8.qdd0, probs8.q_des, probs8.zonos, probs8.masks)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    world = init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        mesh = make_planner_mesh(1)
        init_s = time.perf_counter() - t0
        # the 8 slots of plan_batch's bucket (no culling there), for both
        b8 = obstacle_bucket(probs8.masks)
        args_b8 = (*args8[:4], probs8.zonos[:, :b8], probs8.masks[:, :b8])
        step = sharded_plan_step(spec, cfg, mesh, f32)
        progs = step.planner.batch_programs
        gen = torch.Generator(device=dev).manual_seed(4)
        k_rand = step.planner.random_starts(B, gen)
        local = scatter_worlds(mesh, *(x for x in args8[:4]), k_rand)
        zonos, masks = cp_shard(mesh, args_b8[4]), cp_shard(mesh, args_b8[5])
        fields = ("k", "feasible", "cost", "max_violation", "torque_radius")

        def bits_equal(a, b):
            """Every field equal to the bit (NaN rows too)."""
            view = {f32: torch.int32, f64: torch.int64}
            return all(torch.equal(*(x.view(view[x.dtype]) if x.dtype in view else x
                                     for x in (getattr(a, f), getattr(b, f)))) for f in fields)

        def per_key(key, hits_before):
            """Graphs captured by the program of ``key`` and its hits."""
            return {"graphs": sum(isinstance(st, CapturedStep) and st.graph is not None
                                  for st in progs.entries[key].steps),
                    "hits": progs.hits - hits_before}

        # the kept step: its first call (captures on the card), then replays,
        # each one the timed main path (counts reset before, read after)
        run_step = lambda eager=False: step(*local[:4], zonos, masks, k_rand=local[4],  # noqa: E731
                                            eager=eager)
        gather_obstacles.calls = 0
        res_first, first_s, counts_first = timed("scale_out first call", step.planner, run_step,
                                                 warm=False)
        key8 = (B, b8)
        assert progs.misses == 1 and key8 in progs.entries, progs.stats()
        hits0 = progs.hits
        replays, replay_s = [], []
        for _ in range(5):
            res_s, sec, counts_s = timed("scale_out", step.planner, run_step, warm=False)
            replays.append(res_s)
            replay_s.append(sec)
        cp_gathers = gather_obstacles.calls
        res_e, eager_s, counts_e = timed("scale_out eager", step.planner,
                                         lambda: run_step(eager=True), warm=False)
        assert counts_s == counts_e == counts_first, (counts_s, counts_e, counts_first)
        assert all(bits_equal(r, res_e) for r in (res_first, *replays)), \
            "scale_out: the kept step differs from step(eager=True)"
        programs = {str(key8): per_key(key8, hits0)}
        assert programs[str(key8)]["hits"] == 5 and progs.misses == 1, progs.stats()
        sec_s = statistics.median(replay_s)
        t1 = time.perf_counter()
        summary = gather_summary({"k": res_s.k, "feasible": res_s.feasible}, mesh)
        gather_s = time.perf_counter() - t1
        unsharded = ArmourPlanner(spec, cfg, f32, device=dev)
        res_u, sec_u, _ = timed("scale_out reference", unsharded,
                                lambda: unsharded.plan_batch(*args_b8, k_rand=k_rand), warm=False)
        f_u = res_u.feasible.cpu().numpy()
        assert np.array_equal(summary["feasible"], f_u), "scale_out: feasible differs from plan_batch"
        k_diff = float(np.nan_to_num(np.abs(summary["k"] - res_u.k.cpu().numpy())).max())
        assert np.array_equal(np.isnan(summary["k"]), np.isnan(res_u.k.cpu().numpy()))
        assert k_diff <= 1e-6, f"scale_out: |k_sharded - k_plan_batch| = {k_diff}"
        # the local bank pass a cp = 2 rank makes: half of the 8 slots, and
        # 20 of the 40 of the 40-obstacle worlds, planned through the same
        # step: a program of their own each (first call, then a replay)
        shard_runs = {}
        for label, probs, cap in (("O=4", probs8, b8 // 2), ("O=20", probs40, probs40.masks.shape[1] // 2)):
            a = (probs.q0, probs.qd0, probs.qdd0, probs.q_des, probs.zonos[:, :cap], probs.masks[:, :cap])
            hits_c = progs.hits
            res_c, sec_c, counts_c = timed(f"scale_out {label}", step.planner,
                                           lambda a=a: step(*a, k_rand=k_rand), warm=False)
            res_r, sec_r, counts_r = timed(f"scale_out {label} replay", step.planner,
                                           lambda a=a: step(*a, k_rand=k_rand), warm=False)
            assert counts_r == counts_c and bits_equal(res_r, res_c), f"scale_out {label}: replay differs"
            programs[str((B, cap))] = per_key((B, cap), hits_c)
            shard_runs[label] = {"slots": cap, "first_call_s": sec_c, "replay_s": sec_r,
                                 "plans_per_s": B / sec_r,
                                 "feasible_fraction": float(res_c.feasible.float().mean()),
                                 "launches": counts_r}
            kernel_row(f"{main_name}[{label}]", unsharded, a, counts_c[main_name], seed=30 + cap)
        stats = progs.stats()
        assert stats["evictions"] == 0 and stats["misses"] == 3 and stats["entries"] == 3, stats
        assert all(p["hits"] == (5 if k == str(key8) else 1) for k, p in programs.items()), programs
        if on_card:   # five graphs per program, each captured at its key's first call only
            assert all(p["graphs"] == len(PlanProgram.STEPS) for p in programs.values()), programs
            assert stats["captures"] == 3 * len(PlanProgram.STEPS), stats
        emit({"phase": "scale_out", "backend": dist.get_backend(), "world": list(world),
              "mesh": {"dp": mesh.size(0), "cp": mesh.size(1)}, "batch": B, "T": T, "dtype": "float32",
              "obstacle_slots": b8, "init_s": init_s, "first_call_s": first_s,
              "replay_s": replay_s, "seconds_per_step": sec_s, "plans_per_s": B / sec_s,
              "eager_seconds_per_step": eager_s, "kept_equal_eager_bits": True,
              "kept_fields": list(fields), "launches_equal_eager": True,
              "programs": programs, "program_stats": stats,
              "plan_batch_seconds": sec_u, "feasible_fraction": float(f_u.mean()),
              "feasible_equal": True, "max_abs_k_diff": k_diff, "atol": 1e-6,
              "launches_per_step": counts_s, "cp_gathers": cp_gathers,
              "summary_all_gathers": len(summary), "summary_gather_s": gather_s,
              "cp_shard_local": shard_runs,
              "note": "one card: dp = cp = 1, so the step makes no cp gather; dp > 1 and "
                      "cp > 1 are covered by the gloo tests on the CPU (tests/test_torch_parallel.py)"})
    finally:
        dist.destroy_process_group()


def tool_phases(torch, dev, check_and_time, rows, out_dir):
    """Phases 15-17: the reference-schema export held to the committed
    artifacts (and the offline-set slicing, card against CPU), the
    constraint traces of the committed recording (card against CPU) and the
    figure functions, and the grasp example.  Each path resets the launch
    counts just before it and reads them just after.  Returns the names of
    the kernel rows it added.  ``dev`` exists to rehearse the phases on the
    CPU."""
    from armour_tpu_torch import grasp_example
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.collision.zonotope import ObstacleSet, kernel_layout
    from armour_tpu_torch.config import GraspConfig, PlannerConfig
    from armour_tpu_torch.export_reference_schema import OUT_FILES, export
    from armour_tpu_torch.jrs import offline
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim.recording import load_recording
    from armour_tpu_torch.utils import plotting

    root = os.path.dirname(os.path.abspath(__file__))
    spec = kinova_gen3_spec()
    f32, f64 = torch.float32, torch.float64
    zero = {k.__name__: 0 for k in kernels.KERNELS}
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def numbers(path):
        with open(path) as f:
            return [[float(x) for x in ln.split()] for ln in f if ln.strip()]

    # ---- 15. reference_schema: the export against the committed artifacts ----
    # (rtol, atol) by file ("" for every other), minimum-margin tolerance
    cases = (("float64", f64, "reference_schema",
              {"": (5.5e-10, 1e-15), "armour_main_constraints.out": (5.5e-6, 1e-12)}, 1e-9),
             ("float32", f32, "reference_schema_f32", {"": (1e-5, 1e-12)}, 1e-5))
    for label, dtype, name, tols, margin_tol in cases:
        ref_dir = os.path.join(root, "results", name)
        sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        report = export(os.path.join(out_dir, name), time_steps=128, n_samples=20, dtype=dtype,
                        device=dev)
        sync()
        seconds = time.perf_counter() - t0
        assert kernels.launch_counts() == zero, "the export launched a kernel"
        worst = {}
        for fname in OUT_FILES:
            got = numbers(os.path.join(out_dir, name, fname))
            ref = numbers(os.path.join(ref_dir, fname))
            if fname == "armour_main.out":          # the last line is the build time
                got, ref = got[:-1], ref[:-1]
            assert [len(r) for r in got] == [len(r) for r in ref], f"{label} {fname}: layout"
            g, r = np.concatenate(got), np.concatenate(ref)
            rtol, atol = tols.get(fname, tols[""])
            excess = np.abs(g - r) - (atol + rtol * np.abs(r))
            worst[fname] = float(excess.max())
            assert worst[fname] <= 0.0, f"{label} {fname}: {worst[fname]} over the tolerance"
        with open(os.path.join(ref_dir, "containment_report.json")) as f:
            ref_report = json.load(f)
        margins = {k: report[k] - ref_report[k] for k in ("torque_min_margin_Nm", "link_min_margin_m")}
        assert report["torque_containment_violations"] == 0, report
        assert report["link_center_containment_violations"] == 0, report
        assert all(abs(v) <= margin_tol for v in margins.values()), margins
        emit({"phase": "reference_schema", "pipeline": label, "time_steps": 128,
              "samples_per_interval": 20, "build_ms": report["build_ms"], "seconds": seconds,
              "max_excess_over_tolerance": worst, "report": report, "margin_diff": margins,
              "margin_atol": margin_tol, "launches": kernels.launch_counts()})
    # the offline-set slicing on a synthetic 100-step set (the reference's .mat
    # files are not in the repository): card against CPU
    rng = np.random.default_rng(5)
    Zs = []
    for _ in range(100):
        Z = np.concatenate([rng.uniform(-1, 1, (6, 1)), rng.normal(scale=0.05, size=(6, 6))], axis=1)
        Z[[offline.DIM_KA, offline.DIM_KV], 1:] = 0.0
        Z[offline.DIM_KA, 2], Z[offline.DIM_KV, 5] = 0.3, 0.4
        Z[[offline.DIM_KA, offline.DIM_KV], 0] = 0.1
        Zs.append(Z)
    jrs = offline.OfflineJRS(0.0, 0.5, 1.0, Zs)
    out = {d: offline.sliced_cos_sin_intervals(jrs, 0.7, 0.25, -0.05, device=d) for d in (dev, "cpu")}
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(out[dev][:4], out["cpu"][:4]))
    sl = offline.zonotope_slice(Zs[0], offline.DIM_KV, 0.25, device=dev)
    diff = max(diff, float((sl.cpu() - offline.zonotope_slice(Zs[0], offline.DIM_KV, 0.25,
                                                              device="cpu")).abs().max()))
    assert out[dev][0].device.type == torch.device(dev).type and out[dev][4] == out["cpu"][4]
    assert diff <= 1e-12, f"offline slicing: card against CPU {diff}"
    emit({"phase": "reference_schema", "path": "offline_jrs", "steps": 100, "dtype": "float64",
          "max_abs_diff_card_cpu": diff, "atol": 1e-12})

    # ---- 16. figures: the constraint traces of the committed recording ----
    rec = load_recording(os.path.join(root, "assets", "figures", "scenario3_recording.npz"))
    cfg = PlannerConfig()
    n_it = rec["k"].shape[0]
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr = plotting.constraint_traces(rec, spec, cfg, f32, dev)
    sync()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    values_name = "fused_collision_values_multi"
    # all iterations are one batch and one start: one launch
    assert counts == dict(zero, **{values_name: 1}), counts
    t0 = time.perf_counter()
    tr_cpu = plotting.constraint_traces(rec, spec, cfg, f32, "cpu")
    cpu_seconds = time.perf_counter() - t0
    rad_rel = float((np.abs(tr.torque_radius - rec["torque_radius"]) / np.abs(rec["torque_radius"])).max())
    assert rad_rel <= 1e-5, f"figures: rebuilt torque radii differ from the recording by {rad_rel}"
    feas = tr.feasible
    assert feas.any() and np.array_equal(feas, rec["feasible"])
    assert np.all(tr.col_max[feas] <= cfg.collision_violation_threshold), tr.col_max
    assert np.all(tr.tor_util[feas] <= 0.0), tr.tor_util
    card_cpu = max(float(np.abs(tr.col_max - tr_cpu.col_max).max()),
                   float(np.abs(tr.tor_util - tr_cpu.tor_util).max()))
    assert card_cpu <= 1e-5, f"figures: card against CPU {card_cpu}"
    # every figure function once: None where matplotlib is missing, a PNG where not
    fig_dir = os.path.join(out_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    sub = dict(rec, **{k: rec[k][:2] for k in ("k", "feasible", "q0p", "qd0p", "qdd0p", "torque_radius")})
    cfg16 = PlannerConfig(num_time_steps=16)
    grasp = GraspConfig(object_mass=0.5, u_s=0.6, surf_rad=0.029)

    def fig(name):
        return os.path.join(fig_dir, name)

    drawn = {
        "plot_tracking": plotting.plot_tracking(rec, spec, fig("tracking.png")),
        "plot_torques": plotting.plot_torques(rec, spec, fig("torques.png")),
        "plot_world_topdown": plotting.plot_world_topdown(rec, spec, fig("world.png"), device=dev),
        "plot_frs_topdown": plotting.plot_frs_topdown(sub, spec, fig("frs.png"), cfg=cfg16, device=dev),
        "plot_constraint_traces": plotting.plot_constraint_traces(sub, spec, fig("constraints.png"),
                                                                  cfg=cfg16, device=dev),
        "plot_frs_overlay": plotting.plot_frs_overlay(sub, spec, fig("overlay.png"), cfg=cfg16,
                                                      device=dev),
        "plot_joint_limits": plotting.plot_joint_limits(rec, spec, fig("joint_limits.png")),
        "plot_grasp_wrench": plotting.plot_grasp_wrench(spec, grasp, lambda t: np.zeros(7),
                                                        fig("wrench.png"), device=dev),
        "plot_frs_animation_frames": plotting.plot_frs_animation_frames(sub, spec, fig("frames"),
                                                                        cfg=cfg16, device=dev),
    }
    for name, got in drawn.items():
        assert (got is None) == (not plotting.HAVE_MPL), f"{name} returned {got!r}"
    # the values-only kernel at this batch's shape, against its plain version
    planner = ArmourPlanner(spec, cfg, f32, device=dev)
    prob = planner.build_probs(rec["q0p"], rec["qd0p"], rec["qdd0p"],
                               np.repeat(rec["obstacles"][None], n_it, 0),
                               np.repeat(rec["obstacle_mask"][None], n_it, 0), cull=False)
    hp = prob.hp
    c = kernel_layout(prob.links.slice_with_jac_multi(planner._t(np.nan_to_num(rec["k"]))[:, None])[0])
    traces_row = f"{values_name}[constraint_traces]"
    check_and_time(hp, f32, 2e-6, kernels.fused_collision_values_multi, (hp.A, hp.dpos, hp.dneg, c),
                   False, kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5), traces_row, timed=True)
    rows[traces_row]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows[traces_row]["launches"] = counts[values_name]
    emit({"phase": "figures", "recording": "assets/figures/scenario3_recording.npz",
          "iterations": n_it, "T": cfg.num_time_steps, "dtype": "float32",
          "bucket": int(hp.dpos.shape[-2]), "seconds": seconds, "cpu_seconds": cpu_seconds,
          "launches": counts, "max_rel_torque_radius_diff": rad_rel, "rtol": 1e-5,
          "feasible_iterations": int(feas.sum()),
          "max_col_feasible": float(tr.col_max[feas].max()),
          "max_torque_util_feasible": float(tr.tor_util[feas].max()),
          "max_abs_diff_card_cpu": card_cpu, "atol": 1e-5, "have_matplotlib": plotting.HAVE_MPL,
          "figures": {k: (v if isinstance(v, (str, type(None))) else len(v)) for k, v in drawn.items()}})
    del planner, prob, hp, c

    # ---- 17. grasp_example: two plans through the example's entry point ----
    main_name = "fused_collision_value_jac_multi"
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = grasp_example.main(["--device", str(dev), "--out", os.path.join(out_dir, "grasp_wrench.png")])
    sync()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
    assert res["grasp_feasible"], res
    # the grasp plan and the free plan: one launch per constraint pass each
    assert counts == dict(zero, **{main_name: 2 * passes}), counts
    emit({"phase": "grasp_example", "T": 64, "dtype": "float32", "seconds": seconds,
          "launches": counts, "launches_per_plan": counts[main_name] // 2, **res})
    # the main kernel at the example's shape (one world, 8 slots, T=64)
    gcfg = PlannerConfig(num_time_steps=64, max_obstacles=8)
    q0 = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])
    obs = ObstacleSet.from_boxes([[0.5, 0.3, 0.4]], [[0.15, 0.15, 0.15]], gcfg.max_obstacles)
    grasp_row = f"{main_name}[grasp_example]"
    for dtype, tol in ((f32, 2e-6), (f64, 1e-12)):
        pl = ArmourPlanner(spec, gcfg, dtype, device=dev, grasp=grasp)
        prob = pl.build_probs(q0[None], np.zeros((1, 7)), np.zeros((1, 7)), obs.zonos[None],
                              obs.mask[None], cull=False)
        hp = prob.hp
        K = torch.as_tensor(np.random.default_rng(40).uniform(-0.9, 0.9, (1, gcfg.nlp_num_starts, 7)),
                            dtype=dtype, device=dev)
        c, dc = kernel_layout(*prob.links.slice_with_jac_multi(K)[::2])
        check_and_time(hp, dtype, tol, kernels.fused_collision_value_jac_multi,
                       (hp.A, hp.dpos, hp.dneg, c, dc), True,
                       kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5), grasp_row,
                       timed=dtype == f32)
    rows[grasp_row]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[grasp_row]["launches"] = counts[main_name]
    return [traces_row, grasp_row]


def graph_phases(torch, dev, probs8, probs40, out_dir, T=128):
    """Phase 18: the CUDA graphs of the kept plan programs and of the RK4
    step held against the same steps run op by op (every plan_batch mode,
    SI, rotatotope: the first call of the programs kept per (B, bucket) and
    a replay; two world sets in a row; five controllers in f32 and f64),
    with both times and the capture ms (batch-1 plans: latency_batch1).  Every path resets
    the launch counts just before it and reads them just after.  ``dev``
    and ``T`` exist to rehearse the phase at a small size on the CPU (where
    graph and eager are one path)."""
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.config import GraspConfig, PlannerConfig, SimConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.planner.rotatotope import rotatotope_planner
    from armour_tpu_torch.problems import problem_set
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.sim.agent import CONTROLLERS, TrajParams, TrueParams, rollout_plain
    from armour_tpu_torch.utils.graphs import CapturedStep

    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=T)
    B, n = probs8.q0.shape
    f32, f64 = torch.float32, torch.float64
    main_name = "fused_collision_value_jac_multi"
    zero = {k.__name__: 0 for k in kernels.KERNELS}
    on_card = torch.device(dev).type == "cuda"
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(fn):
        """(result, seconds, launches, capture ms) of fn()."""
        sync()
        kernels.reset_launch_counts()
        CapturedStep.last_capture_ms = 0.0
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0, kernels.launch_counts(), CapturedStep.last_capture_ms

    def bits(x):
        x = x.detach().cpu().contiguous()
        if not x.is_floating_point():
            return x
        return x.view({f64: torch.int64, f32: torch.int32}[x.dtype])

    def same(a, b):
        return torch.equal(bits(a), bits(b))

    # ---- 18. graphs: every plan_batch path, graph against eager ----------
    grasp = GraspConfig(object_mass=0.2, u_s=0.6, surf_rad=0.03)
    q_tray = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])
    q0_g = q_tray + np.random.default_rng(0).uniform(-0.05, 0.05, (B, n))
    zonos_g = np.zeros((B, cfg.max_obstacles, 4, 3))
    zonos_g[:, 0, 0], zonos_g[:, 0, 1:] = 5.0, 0.05 * np.eye(3)
    masks_g = np.zeros((B, cfg.max_obstacles), bool)
    masks_g[:, 0] = True
    near = problem_set(cfg, B, n_obs=8, seed=0, device=dev, q_center=Q_SI)
    near = near._replace(qd0=np.zeros_like(near.q0), qdd0=np.zeros_like(near.q0))
    args8, args40, args_si = (tuple(p) for p in (probs8, probs40, near))
    args_g = (q0_g, np.zeros((B, n)), np.zeros((B, n)), q0_g + 0.3 * cfg.k_range, zonos_g, masks_g)
    cases = (
        ("8obs", ArmourPlanner(spec, cfg, f32, device=dev), args8, {main_name: passes}),
        ("40obs", ArmourPlanner(spec, cfg, f32, device=dev), args40, {main_name: passes}),
        ("orig", ArmourPlanner(spec, cfg, f32, device=dev, traj_type="orig"), args8, {main_name: passes}),
        ("12starts", ArmourPlanner(spec, dataclasses.replace(cfg, nlp_num_starts=12), f32, device=dev),
         args8, {main_name: passes}),
        ("smooth", ArmourPlanner(spec, dataclasses.replace(cfg, smooth_collision_tau=1e-3), f32,
                                 device=dev), args8, {"fused_collision_values_multi": 1}),
        ("grasp", ArmourPlanner(spec, cfg, f32, device=dev, grasp=grasp), args_g, {main_name: passes}),
        ("bernstein+si", ArmourPlanner(spec, cfg, f32, device=dev, self_intersection=True), args_si,
         {main_name: passes}),
        ("rotatotope", rotatotope_planner(spec, cfg, f32, device=dev), args8, {main_name: passes}),
    )
    plan_rows = {}
    for label, pl, args, expect in cases:
        k_rand = pl.random_starts(B, torch.Generator(device=dev).manual_seed(4))
        res, secs, counts = {}, {}, {}
        # eager, then the kept programs' first call (captures) and a replay
        for key in ("eager", "first", "replay"):
            res[key], secs[key], counts[key], _ = run(
                lambda: pl.plan_batch(*args, k_rand=k_rand, eager=key == "eager"))
            assert counts[key] == dict(zero, **expect), f"graphs {label}: launches {counts[key]}"
            if key == "first":
                cache = pl.batch_programs.stats()
                cap = sum(st.capture_ms for p in pl.batch_programs.entries.values() for st in p.steps
                          if isinstance(st, CapturedStep))
        assert pl.batch_programs.stats()["captures"] == cache["captures"], f"graphs {label}: recaptured"
        a = res["eager"]
        equal = {k: {"k": same(a.k, g.k), "feasible": torch.equal(a.feasible, g.feasible),
                     "max_violation": same(a.max_violation, g.max_violation)}
                 for k, g in (("first", res["first"]), ("replay", res["replay"]))}
        k_diff = max(float(np.nan_to_num((a.k - res[k].k).abs().cpu().numpy()).max())
                     for k in ("first", "replay"))
        assert all(all(e.values()) for e in equal.values()), \
            f"graphs {label}: kept plan against eager {equal}, |dk| {k_diff}"
        g = res["replay"]
        plan_rows[label] = {"eager_s": secs["eager"], "graph_s": secs["replay"],
                            "first_call_s": secs["first"],
                            "eager_plans_per_s": B / secs["eager"],
                            "graph_plans_per_s": B / secs["replay"],
                            "capture_ms": cap, "graphs": cache["captures"],
                            "program_keys": [str(k) for k in pl.batch_programs.entries],
                            "bits_equal": equal, "max_abs_k_diff": k_diff,
                            "feasible_fraction": float(g.feasible.float().mean()),
                            "launches_graph": counts["replay"]}
        pl.batch_programs.clear()
        emit({"phase": "graphs", "path": "plan_batch", "mode": label, "batch": B, "T": T,
              "dtype": "float32", **plan_rows[label]})
        del res, a, g, pl
    del cases
    # two different world sets in a row: each graph belongs to its own solve
    pl = ArmourPlanner(spec, cfg, f32, device=dev)
    sets = [args8, tuple(problem_set(cfg, B, n_obs=8, seed=3, device=dev))]
    k_rand = pl.random_starts(B, torch.Generator(device=dev).manual_seed(5))
    graphed = [run(lambda a=a: pl.plan_batch(*a, k_rand=k_rand))[0] for a in sets]
    eager_r = [pl.plan_batch(*a, k_rand=k_rand, eager=True) for a in sets]
    consecutive = [same(x.k, y.k) and torch.equal(x.feasible, y.feasible) for x, y in zip(graphed, eager_r)]
    assert all(consecutive), f"graphs: consecutive solves against eager {consecutive}"
    assert not same(graphed[0].k, graphed[1].k), "graphs: the two world sets gave the same plans"
    emit({"phase": "graphs", "path": "consecutive_world_sets", "sets": 2, "equal_to_eager": consecutive})
    del graphed, eager_r, sets

    # the plain rollout's RK4 step (the rollout kernel's reference): 200 steps
    # of every controller, f32 and f64
    sim = dataclasses.replace(SimConfig(), t_move=200 * SimConfig().plant_dt)
    rng = np.random.default_rng(0)
    nw = min(16, B)
    traj = TrajParams(probs8.q0[:nw], probs8.qd0[:nw], probs8.qdd0[:nw],
                      rng.uniform(-1, 1, (nw, n)) * cfg.k_range, np.zeros(nw))
    scale = rng.uniform(0.97, 1.03, (nw, spec.n_joints))
    roll_rows = []
    for dtype in (f32, f64):
        for ctrl in CONTROLLERS:
            outs, secs, caps = {}, {}, {}
            for eager in (True, False):
                outs[eager], secs[eager], _, caps[eager] = run(lambda: rollout_plain(
                    spec, sim, traj.q0, traj.qd0, traj, TrueParams(scale, scale), controller=ctrl,
                    device=dev, dtype=dtype, eager=eager))
            (qa, qda, la), (qg, qdg, lg) = outs[True], outs[False]
            equal = same(qa, qg) and same(qda, qdg) and all(same(x, y) for x, y in zip(la, lg))
            q_diff = float((qa - qg).abs().max())
            assert equal or q_diff <= (1e-9 if dtype == f64 else 1e-6), \
                f"graphs rollout {ctrl} {dtype}: |q_end graph - eager| = {q_diff}"
            row = {"controller": ctrl, "dtype": str(dtype)[6:], "worlds": nw, "steps": 200,
                   "eager_ms_per_step": secs[True] / 200 * 1e3, "graph_ms_per_step": secs[False] / 200 * 1e3,
                   "capture_ms": caps[False], "bits_equal": equal, "max_abs_q_end_diff": q_diff}
            roll_rows.append(row)
            emit({"phase": "graphs", "path": "rollout", **row})
    with open(os.path.join(out_dir, "graphs.json"), "w") as f:
        json.dump({"plan_batch": plan_rows, "rollout": roll_rows}, f, indent=1)


def latency_phase(torch, dev, check_and_time, rows, probs8, probs40, n_replays=5, T=128):
    """Phase 4b, latency_batch1: plan() through its program kept per
    obstacle bucket (five graphs kept across calls: the build, the solver's
    first bank pass, its inner iteration, its outer update and the
    verification): the first call (capture included) and ``n_replays``
    replays on other worlds of the same bucket; then, through ``plan`` and its
    cache, the bucket sequence 8 -> 16 -> 8.  Every plan is held to the
    eager ``plan`` (op by op, no program) to the bit (k, feasible,
    max_violation), every replay to 65 main-kernel launches.  Then the main
    kernel on the batch-1 bank against its plain version, and the collision
    check of world 0's plan on that bank (the values-only and single-start
    kernels, one launch each) and those two kernels against their plain
    versions.  Returns the three rows' names.  Each path resets
    the launch counts just before it and reads them just after.  ``dev``,
    ``n_replays`` and ``T`` exist to rehearse the phase at a small size on
    the CPU (where the program runs op by op)."""
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.collision.zonotope import (
        ObstacleSet,
        collision_constraints_with_jac,
        collision_values_multi,
        kernel_layout,
    )
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner, PlanProgram
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.utils.graphs import CapturedStep

    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=T)
    f32 = torch.float32
    main_name = "fused_collision_value_jac_multi"
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
    on_card = torch.device(dev).type == "cuda"
    pl = ArmourPlanner(spec, cfg, f32, device=dev)

    def timed(fn):
        """(result, ms, main-kernel launches) of fn()."""
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, kernels.launch_counts()[main_name]

    def bits(x):
        x = x.detach().cpu().contiguous()
        return x.view(torch.int32) if x.dtype == f32 else x

    def equal(a, b):
        return {f: torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))
                for f in ("k", "feasible", "max_violation")}

    # worlds 0..n_replays of the 8-obstacle set (bucket 8), and one world of
    # the 40-obstacle set with 12 live slots (bucket 16)
    worlds = [(probs8.q0[i], probs8.qd0[i], probs8.qdd0[i], probs8.q_des[i],
               ObstacleSet(probs8.zonos[i], probs8.masks[i])) for i in range(n_replays + 1)]
    m16 = np.asarray(probs40.masks[0]).copy()
    m16[12:] = False
    worlds.append((probs40.q0[0], probs40.qd0[0], probs40.qdd0[0], probs40.q_des[0],
                   ObstacleSet(probs40.zonos[0], m16)))
    k_rand = [pl.random_starts(1, torch.Generator(device=dev).manual_seed(20 + i))[0]
              for i in range(len(worlds))]
    eager = [timed(lambda i=i: pl.plan(*worlds[i], k_rand=k_rand[i], eager=True))
             for i in range(len(worlds))]
    assert all(e[2] == passes for e in eager), [e[2] for e in eager]

    def check(res, i, label):
        eq = equal(res, eager[i][0])
        assert all(eq.values()), f"latency_batch1 {label}: plan against eager {eq}"
        return eq

    b, args0 = pl.plan_args(*worlds[0], k_rand=k_rand[0])
    prog = PlanProgram(pl, b)
    first, first_ms, n0 = timed(lambda: prog(*args0))
    check(row0(first), 0, "first call")
    replays = []
    for i in range(1, n_replays + 1):
        b_i, args = pl.plan_args(*worlds[i], k_rand=k_rand[i])
        assert b_i == b, (b_i, b)
        res, ms, n_launch = timed(lambda: prog(*args))
        check(row0(res), i, f"replay {i}")
        assert n_launch == passes, f"latency_batch1: {n_launch} launches per replay"
        replays.append(ms)
    program = {
        "first_call_ms": first_ms, "first_call_launches": n0,
        "capture_ms": {name: s.capture_ms for name, s in zip(PlanProgram.STEPS, prog.steps)
                       if isinstance(s, CapturedStep)},
        "graphs": sum(isinstance(s, CapturedStep) for s in prog.steps),
        "replay_median_ms": statistics.median(replays), "replay_runs_ms": replays,
        "launches_per_replay": passes, "bits_equal": True}
    prog.release()
    del prog

    # through plan() and its cache: buckets 8 -> 16 -> 8 (world 1 replays
    # the program world 0 made, world 2 after the bucket change)
    seq = []
    for i, bucket in ((0, 8), (1, 8), (n_replays + 1, 16), (2, 8)):
        res, ms, n_launch = timed(lambda i=i: pl.plan(*worlds[i], k_rand=k_rand[i]))
        check(res, i, f"plan bucket {bucket}")
        assert n_launch == passes, n_launch
        seq.append({"world": i, "bucket": bucket, "ms": ms, "launches": n_launch})
    cache = pl.programs.stats()
    assert (cache["hits"], cache["misses"]) == (2, 2), cache
    emit({"phase": "latency_batch1", "T": T, "dtype": "float32",
          "median_ms": statistics.median(s["ms"] for s in seq if s["world"] in (1, 2)),
          "program": program, "bucket_sequence": seq, "cache": cache,
          "eager_ms": [e[1] for e in eager], "eager_median_ms": statistics.median(e[1] for e in eager)})

    # the main kernel on the batch-1 bank of the program (B = 1, bucket 8)
    _, args0 = pl.plan_args(*worlds[0], k_rand=k_rand[0])
    prob = pl.build_fixed(*args0[:3], *args0[4:6])
    hp = prob.hp
    K = torch.as_tensor(np.random.default_rng(8).uniform(-0.9, 0.9, (1, cfg.nlp_num_starts, 7)),
                        dtype=f32, device=dev)
    c, dc = kernel_layout(*prob.links.slice_with_jac_multi(K)[::2])
    name = "fused_collision_value_jac_multi[batch1]"
    check_and_time(hp, f32, 2e-6, kernels.fused_collision_value_jac_multi,
                   (hp.A, hp.dpos, hp.dneg, c, dc), True,
                   kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c, tol=1e-5), name, timed=True)
    rows[name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[name]["launches"] = seq[1]["launches"]

    # the collision check of world 0's plan on the same bank, as a user runs
    # it after plan(): the values-only and single-start kernels, one launch each
    plan0 = eager[0][0]
    k_chk = torch.where(plan0.feasible, plan0.k, 0.0)[None, None]        # (1, 1, n)
    centers, _, dcenters = prob.links.slice_with_jac_multi(k_chk)
    kernels.reset_launch_counts()
    g_multi = collision_values_multi(hp, centers)
    g_one, _ = collision_constraints_with_jac(hp, centers[:, 0], dcenters[:, 0])
    if on_card:
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts == {main_name: 0, "fused_collision_values_multi": 1,
                      "fused_collision_value_jac": 1}, counts
    assert torch.equal(g_multi[:, 0], g_one), "batch-1 check: the two check kernels disagree"
    emit({"phase": "check_path_batch1", "launches": counts, "feasible": bool(plan0.feasible),
          "max_collision_value": float(g_multi.max())})
    c1, dc1 = kernel_layout(centers, dcenters)
    uniq1 = kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c1, tol=1e-5)
    name_v = "fused_collision_values_multi[batch1]"
    name_1 = "fused_collision_value_jac[batch1]"
    check_and_time(hp, f32, 2e-6, kernels.fused_collision_values_multi, (hp.A, hp.dpos, hp.dneg, c1),
                   False, uniq1, name_v, timed=True)
    check_and_time(hp, f32, 2e-6, kernels.fused_collision_value_jac,
                   (hp.A, hp.dpos, hp.dneg, c1[:, 0].contiguous(), dc1[:, 0].contiguous()), True,
                   uniq1, name_1, timed=True)
    rows[name_v]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows[name_1]["replaces"] = "armour_tpu/collision/pallas_kernel.py:85"
    rows[name_v]["launches"] = counts["fused_collision_values_multi"]
    rows[name_1]["launches"] = counts["fused_collision_value_jac"]
    return [name, name_v, name_1]


def row0(res):
    """The world row of a PlanProgram's (1, ...) result, as plan() returns it."""
    return type(res)(*(x[0] for x in res))


def entry_point_phases(torch, dev, out_dir, sweep_argv=(), example_argv=()):
    """Phases 19-20: the controller sweep held to
    results/r4_controller_sweep.json, and the simple example's full
    episode, each through its entry point.  Each path resets the launch
    counts just before it and reads them just after.  ``dev`` and the two
    argument lists exist to rehearse the phases at a small size on the
    CPU."""
    from armour_tpu_torch import compare_controllers, simple_example
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.config import PlannerConfig

    cfg = PlannerConfig()
    main_name = "fused_collision_value_jac_multi"
    zero = {k.__name__: 0 for k in kernels.KERNELS}
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1

    def run(fn):
        """(result, seconds, launches) of fn()."""
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernels.launch_counts()

    # ---- 19. controller_sweep: the full sweep, held to the committed table ----
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "results", "r4_controller_sweep.json")) as f:
        committed = {(r["controller"], r["uncertainty"]): r for r in json.load(f)["rows"]}
    sweep_out = os.path.join(out_dir, "controller_sweep.json")
    table, seconds, counts = run(lambda: compare_controllers.main(["--out", sweep_out, "--device", str(dev),
                                                                   *sweep_argv]))
    assert counts == zero, counts
    worst = 0.0
    for row in table["rows"]:
        ref = committed[(row["controller"], row["uncertainty"])]
        assert row["within_ultimate_bound"] == ref["within_ultimate_bound"], (row, ref)
        for k in ("max_pos_err", "mean_pos_err", "max_vel_err"):
            worst = max(worst, abs(row[k] - ref[k]) / abs(ref[k]))
    # the tolerance tests/test_torch_compare_controllers.py states
    assert worst <= SWEEP_RTOL, f"controller_sweep: rows differ from the committed table by {worst}"
    emit({"phase": "controller_sweep", "rows": len(table["rows"]), "seconds": seconds,
          "flags_equal": True, "max_rel_err": worst, "rtol": SWEEP_RTOL,
          "outside_bound": sorted(f"{r['controller']}@{r['uncertainty']:.0%}" for r in table["rows"]
                                  if not r["within_ultimate_bound"])})

    # ---- 20. simple_example: the full episode through its entry point ----
    res, seconds, counts = run(lambda: simple_example.main(
        ["--out-dir", os.path.join(out_dir, "simple_example"), "--device", str(dev), *example_argv]))
    assert res["goal_reached"] and not res["collision"], res
    assert counts == dict(zero, **{main_name: passes * res["iterations"]}), counts
    emit({"phase": "simple_example", "seconds": seconds, "launches": counts,
          **{k: v for k, v in res.items() if k not in ("npz", "csv")}})


def comparison_phases(torch, dev, out_dir, cmp_argv=(), scaling_argv=("--production",)):
    """Phases 21-22: run_armtd_comparison over the 100 worlds of
    assets/worlds, 2 iterations per half, each half's JSON keys those of
    results/r4_armtd_vs_armour.json plus the port's device and protocol, 0
    collisions, 65 main-kernel launches per iteration of each half; then
    bench_scaling on this card's NCCL rank at the production shapes, its
    rows' keys those of results/r5_scaling_virtual8.json.  Each half resets
    the launch counts just before it and reads them just after (the
    scaling rank is a process of its own).  ``cmp_argv`` and
    ``scaling_argv`` exist to rehearse the phases at a small size on the
    CPU."""
    from armour_tpu_torch import bench_scaling, run_armtd_comparison
    from armour_tpu_torch.collision import kernels
    from armour_tpu_torch.config import PlannerConfig

    cfg = PlannerConfig()
    main_name = "fused_collision_value_jac_multi"
    zero = {k.__name__: 0 for k in kernels.KERNELS}
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
    on_card = torch.device(dev).type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "results", "r4_armtd_vs_armour.json")) as f:
        jax_file = json.load(f)
    out = os.path.join(out_dir, "armtd_comparison.json")
    if os.path.exists(out):
        os.remove(out)
    halves = {}
    for half in ("armour", "armtd"):
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        d = run_armtd_comparison.main(["--max-iterations", "2", "--out", out, "--device", str(dev),
                                       "--halves", half, *cmp_argv])[half]
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        extra = set(d) ^ set(jax_file[half])
        assert extra == {"device", "protocol"}, f"armtd_comparison {half}: keys differ by {sorted(extra)}"
        assert d["collision"] == 0, f"armtd_comparison {half}: {d['collision']} collisions"
        its = max(w["iterations"] for w in d["worlds"])
        assert counts == dict(zero, **{main_name: passes * its}), f"armtd_comparison {half}: {counts}"
        halves[half] = {"seconds": seconds, "launches": counts, "iterations": its,
                        **{k: d[k] for k in ("n_worlds", "goal_reached", "collision", "torque_violation",
                                             "joint_limit_violation", "ultimate_bound_violation",
                                             "stopped_safely", "traj_type")}}
    with open(out) as f:
        assert sorted(json.load(f)) == ["armour", "armtd"]
    emit({"phase": "armtd_comparison", "halves": halves, "keys_equal_jax_file": True,
          "out": os.path.relpath(out, root)})

    # ---- 22. bench_scaling: the one-card NCCL row ------------------------
    with open(os.path.join(root, "results", "r5_scaling_virtual8.json")) as f:
        row_keys = set(json.load(f)["rows"][0])
    t0 = time.perf_counter()
    table = bench_scaling.main(["--out", os.path.join(out_dir, "bench_scaling.json"), *scaling_argv])
    seconds = time.perf_counter() - t0
    assert table["rows"] and all(set(r) == row_keys for r in table["rows"]), table["rows"]
    emit({"phase": "bench_scaling", "seconds": seconds, "rows": table["rows"],
          "steps": table.get("steps"), "time_steps": table["time_steps"],
          "row_keys_equal_jax_file": True, "device": table.get("device")})


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# the rollout kernel against rollout_plain, the tolerances of
# tests/test_torch_rollout_cuda.py: float64 end state 1e-9 and every log
# field 1e-8 of its largest magnitude; float32 q 1e-4 rad, qd 1e-3 rad/s, u
# 1e-3 of its largest magnitude
ROLLOUT_FIELDS = ("q", "qd", "q_ref", "qd_ref", "u")


def rollout_errors(got, ref) -> dict:
    """Max |kernel - plain| of the end state and of each log field, and each
    field's error over its largest magnitude (``<field>_rel``)."""
    (qk, qdk, lk), (qp, qdp, lp) = got, ref
    out = {"q_end": float((qk - qp).abs().max()), "qd_end": float((qdk - qdp).abs().max())}
    for name in ROLLOUT_FIELDS:
        a, b = getattr(lk, name), getattr(lp, name)
        out[name] = float((a - b).abs().max())
        out[name + "_rel"] = out[name] / max(float(b.abs().max()), 1e-30)
    return out


def rollout_within(e: dict, f64: bool) -> bool:
    if f64:
        return (e["q_end"] <= 1e-9 and e["qd_end"] <= 1e-9
                and all(e[f + "_rel"] <= 1e-8 for f in ROLLOUT_FIELDS))
    return (max(e["q_end"], e["q"], e["q_ref"]) <= 1e-4
            and max(e["qd_end"], e["qd"], e["qd_ref"]) <= 1e-3 and e["u_rel"] <= 1e-3)


def rollout_phase(torch, dev, rows, peak_bw, peak_f32, B=128, steps=200, move_steps=1000,
                  move_batches=(128, 100), ptxas_rows=()):
    """Phase 3b, rollout_kernel: the rollout kernel (`csrc/rollout.cu`, one
    launch per move) against ``rollout_plain`` on the same inputs and noise:
    the five controllers x bernstein/orig x f32/f64 at ``steps`` steps and
    the planar 2- and 6-link arms, at B worlds, with the battery's safety
    flags equal; then the battery's move (robust, f32, ``move_steps`` steps,
    with measurement noise) timed with CUDA events beside the plain version
    (the graph of its step), with its bounds; then the move at each of
    ``move_batches`` in float32 and float64, timed (float64 at B also held
    to the plain version).  ``ptxas_rows`` (the build's per-instantiation
    registers, spills and shared memory) go into the row.  Fills
    ``rows["fused_rollout"]``."""
    from armour_tpu_torch.bench_bank import graph_ms
    from armour_tpu_torch.config import PlannerConfig, SimConfig
    from armour_tpu_torch.planner.armour import wrap_to_pi
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec
    from armour_tpu_torch.robots.planar import planar_arm_spec
    from armour_tpu_torch.sim import rollout_kernel as rk
    from armour_tpu_torch.sim.agent import CONTROLLERS, TrajParams, TrueParams, rollout, rollout_plain
    from armour_tpu_torch.sim.harness import _limits

    f32, f64 = torch.float32, torch.float64
    cfg = PlannerConfig()
    kinova = kinova_gen3_spec()

    def inputs(spec, n_steps, seed, dtype, B=B):
        rng = np.random.default_rng(seed)
        nf = spec.n_factors
        q0, qd0 = rng.uniform(-1, 1, (B, nf)), rng.uniform(-0.3, 0.3, (B, nf))
        traj = TrajParams(q0, qd0, rng.uniform(-0.5, 0.5, (B, nf)),
                          rng.uniform(-1, 1, (B, nf)) * cfg.k_range, rng.uniform(0.0, 0.5, B))
        scale = rng.uniform(*SimConfig().uncertain_mass_range, (B, spec.n_joints))
        sim = dataclasses.replace(SimConfig(), t_move=n_steps * SimConfig().plant_dt)
        noise = torch.as_tensor(rng.normal(scale=1e-4, size=(n_steps, 2, B, nf)), dtype=dtype,
                                device=dev)
        return (sim, q0, qd0, traj, TrueParams(scale, scale)), noise

    def flags(spec, log):
        lim = _limits(spec, log.q.dtype, log.q.device)
        return torch.stack([
            (log.u.abs() > lim.tlim + 1e-6).flatten(1).any(-1),
            ((log.q < lim.pos_lb) | (log.q > lim.pos_ub)).flatten(1).any(-1)
            | (log.qd.abs() > lim.spd + 1e-6).flatten(1).any(-1),
            (wrap_to_pi(log.q - log.q_ref).abs() > lim.ub_pos + 1e-6).flatten(1).any(-1)
            | ((log.qd - log.qd_ref).abs() > lim.ub_vel + 1e-6).flatten(1).any(-1)])

    def both(spec, args, noise, controller, traj_type, dtype):
        kw = dict(duration=1.0, noise=noise, controller=controller, traj_type=traj_type,
                  device=dev, dtype=dtype)
        rk.reset_launch_counts()
        got = rollout(spec, *args, **kw)
        torch.cuda.synchronize()
        launches = rk.launch_counts()["fused_rollout"]
        ref = rollout_plain(spec, *args, **kw)
        torch.cuda.synchronize()
        return got, ref, launches

    cases = [(kinova, c, t, d) for c in CONTROLLERS for t in ("bernstein", "orig") for d in (f32, f64)]
    # the planar arms start on their reference (t_offset 0): far from it the
    # 6-link arm's stiff closed loop amplifies rounding by ~1e11 within 40
    # steps in either version (tests/test_torch_rollout_cuda.py::test_planar_arms)
    cases += [(planar_arm_spec(k), "robust", "bernstein", d) for k in (2, 6) for d in (f32, f64)]
    worst = {}
    for i, (spec, controller, traj_type, dtype) in enumerate(cases):
        args, noise = inputs(spec, steps, i, dtype)
        if spec.name != kinova.name:
            args = (*args[:3], args[3]._replace(t_offset=np.zeros(B)), args[4])
        got, ref, launches = both(spec, args, noise, controller, traj_type, dtype)
        e = rollout_errors(got, ref)
        same_flags = torch.equal(flags(spec, got[2]), flags(spec, ref[2]))
        ok = launches == 1 and rollout_within(e, dtype == f64) and same_flags
        emit({"phase": "rollout_kernel", "robot": spec.name, "controller": controller,
              "traj_type": traj_type, "dtype": str(dtype)[6:], "worlds": B, "steps": steps,
              "launches": launches, "errors": e, "safety_flags_equal": same_flags, "ok": ok})
        assert ok, f"rollout kernel {spec.name} {controller} {traj_type} {dtype}: {e}, {launches}"
        key = str(dtype)[6:]
        worst[key] = max(worst.get(key, 0.0), max(v for k, v in e.items() if not k.endswith("_rel")))
        del got, ref, noise

    # the battery's move: robust, f32, 1,000 steps
    args, noise = inputs(kinova, move_steps, 99, f32)
    got, ref, launches = both(kinova, args, noise, "robust", "bernstein", f32)
    e = rollout_errors(got, ref)
    assert launches == 1 and rollout_within(e, False), f"rollout kernel, the move: {e}"
    kw = dict(duration=1.0, noise=noise, controller="robust", device=dev, dtype=f32)
    ms = time_ms(torch, lambda: rollout(kinova, *args, **kw), reps=10, warmup=2)
    plain_ms = time_ms(torch, lambda: rollout_plain(kinova, *args, **kw), reps=3, warmup=1)
    sim, q0, qd0, traj, true = args
    on = lambda x: torch.as_tensor(x, dtype=f32, device=dev)  # noqa: E731
    # the device alone: 20 moves from one CUDA graph (inputs on the card, as
    # the kept move-and-check stage holds them); the plain version keeps its
    # own graph of the step and cannot be captured inside another
    on_args = (sim, on(q0), on(qd0), TrajParams(*map(on, traj)), TrueParams(*map(on, true)))
    in_graph_ms = graph_ms(lambda: rollout(kinova, *on_args, **kw), reps=3)
    packed = rk.pack(kinova, *on_args[1:])
    moved = nbytes(packed.spec, packed.ispec, packed.world, noise, got[0], got[1], *got[2][1:])
    ops = rk.operation_count(kinova, "robust", "bernstein", move_steps, B)
    b_mem, b_ops = moved / peak_bw * 1e3, ops / peak_f32 * 1e3
    clock = sm_clock_hz()
    chain_ms = rk.dependent_ops_per_step(kinova) * move_steps * 4 / clock * 1e3
    # the move at each width and in both types: one block of eight warps per world
    moves_ms = {}
    for dtype in (f32, f64):
        for b_move in move_batches:
            key = f"{str(dtype)[6:]}_B{b_move}"
            m_args, m_noise = inputs(kinova, move_steps, 99, dtype, B=b_move)
            m_kw = dict(duration=1.0, noise=m_noise, controller="robust", device=dev, dtype=dtype)
            moves_ms[key] = time_ms(torch, lambda: rollout(kinova, *m_args, **m_kw), reps=10,
                                    warmup=2)
            if dtype == f64 and b_move == B:
                m_got, m_ref, m_launches = both(kinova, m_args, m_noise, "robust", "bernstein", f64)
                m_err = rollout_errors(m_got, m_ref)
                assert m_launches == 1 and rollout_within(m_err, True), f"the f64 move: {m_err}"
                worst["float64_move"] = max(v for k, v in m_err.items() if not k.endswith("_rel"))
                del m_got, m_ref
            del m_noise
    rows["fused_rollout"] = {
        "name": "fused_rollout", "wrapper": "fused_rollout", "route": "cuda",
        "source": "armour_tpu_torch/csrc/rollout.cu", "replaces": "armour_tpu/sim/agent.py:236",
        "launches": None, "max_abs_err_float32": max(v for k, v in e.items() if not k.endswith("_rel")),
        "ms": ms, "plain_ms": plain_ms, "graph_ms": in_graph_ms, "plain_graph_ms": None,
        "bytes": moved, "ops": ops,
        "bound_ms": max(b_mem, b_ops), "bound_by": "bytes" if b_mem >= b_ops else "operations",
        "library_ms": None, "chain_bound_ms": chain_ms,
        "shapes": {"B": B, "steps": move_steps, "nf": kinova.n_factors},
        "block": {"threads": rk.THREADS, "warps": rk.THREADS // 32, "blocks": B},
        "moves_ms": moves_ms, "ptxas": list(ptxas_rows),
    }
    emit({"phase": "rollout_kernel", "move": "robust, bernstein, float32, with noise", "worlds": B,
          "steps": move_steps, "launches": launches, "errors": e, "ms_per_move": ms,
          "ms_per_move_in_graph": in_graph_ms, "plain_graph_ms_per_move": plain_ms,
          "bytes": moved, "ops": ops,
          "bound_ms": rows["fused_rollout"]["bound_ms"], "bound_by": rows["fused_rollout"]["bound_by"],
          "chain_bound_ms": chain_ms, "sm_clock_hz": clock,
          "dependent_ops_per_step": rk.dependent_ops_per_step(kinova),
          "block": rows["fused_rollout"]["block"], "moves_ms": moves_ms,
          "ptxas": rows["fused_rollout"]["ptxas"],
          "max_abs_err_by_dtype": worst, "nvidia_smi": nvidia_smi()})


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
    from armour_tpu_torch.bench_bank import graph_ms
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
    from armour_tpu_torch.sim import rollout_kernel as rk
    from armour_tpu_torch.sim.agent import TrajParams, TrueParams, rollout
    from armour_tpu_torch.sim.world import arm_collision_check
    from armour_tpu_torch.utils.graphs import CapturedStep, KeptFunction

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

    with ThreadPoolExecutor(3) as pool:    # one nvcc per CUDA source and g++, all at once
        oracle_build = pool.submit(mesh_oracle.build)
        rollout_build = pool.submit(rk.build, True)
        info = kernels.build(verbose=True)
        oracle_lib = oracle_build.result()
        rinfo = rollout_build.result()
    with open(os.path.join(out_dir, "collision_bank_ptxas.txt"), "w") as f:
        f.write(info["log"])
    with open(os.path.join(out_dir, "rollout_ptxas.txt"), "w") as f:
        f.write(rinfo["log"])
    ptxas = kernels.ptxas_summary(info["log"])
    rptxas = kernels.ptxas_summary(rinfo["log"])
    spilling = [r for r in ptxas + rptxas if r["spill_stores"] or r["spill_loads"]]
    emit({"phase": "build", "seconds": round(info["seconds"], 3), "built": info["built"],
          "library": os.path.relpath(info["path"]), "instantiations": len(ptxas),
          "registers_f32_offsets": {r["kernel"]: r["registers"] for r in ptxas if ",f32," in r["kernel"]},
          "max_registers": max((r["registers"] for r in ptxas), default=None), "spilling": spilling,
          "rollout": {"seconds": round(rinfo["seconds"], 3), "built": rinfo["built"],
                      "library": os.path.relpath(rinfo["path"]), "instantiations": len(rptxas),
                      "ptxas": rptxas},
          "mesh_oracle": os.path.relpath(oracle_lib),
          "mesh_oracle_openmp": oracle_lib == mesh_oracle.library_path(mesh_oracle.VARIANTS[0])})
    assert not info["built"] or (ptxas and not spilling), f"ptxas reports spills: {spilling}"
    assert not rinfo["built"] or (len(rptxas) == rk.INSTANTIATIONS and not spilling), \
        f"rollout ptxas: {rptxas}"

    spec = kinova_gen3_spec()
    cfg = PlannerConfig()
    dev = "cuda"
    B, S, n = 128, cfg.nlp_num_starts, spec.n_factors

    # ---- 3. kernels against their plain versions -------------------------
    # the floor under any launch: an empty kernel, 20 launches in one graph
    floor_ms = graph_ms(lambda: kernels._launch_empty())
    emit({"phase": "launch_floor", "grid": [1, 32], "graph_ms": floor_ms,
          "ms": time_ms(torch, kernels._launch_empty),
          "sm_count": torch.cuda.get_device_properties(0).multi_processor_count})
    probs8 = problem_set(cfg, B, n_obs=8, seed=0, device=dev)
    K_np = np.random.default_rng(1).uniform(-0.9, 0.9, (B, S, n))
    S_pool = 2 * S + 2   # the smooth-mode verification pool: ONE values-only launch
    K_pool_np = np.random.default_rng(3).uniform(-0.9, 0.9, (B, S_pool, n))
    pool_name = f"fused_collision_values_multi[S={S_pool}]"
    S_many = 12          # more starts than one start group of the kernel holds: still one launch
    K_many_np = np.random.default_rng(5).uniform(-0.9, 0.9, (B, S_many, n))
    many_name = f"fused_collision_value_jac_multi[S={S_many}]"
    S_many_pool = 2 * S_many + 2   # a 12-start plan's smooth-mode pool: one values-only launch
    K_many_pool_np = np.random.default_rng(6).uniform(-0.9, 0.9, (B, S_many_pool, n))
    many_pool_name = f"fused_collision_values_multi[S={S_many_pool}]"
    wide_name = "fused_collision_value_jac_multi[O=16]"   # the 40-obstacle bank
    rows = {}
    zero_counts = {k.__name__: 0 for k in kernels.KERNELS}

    def check_and_time(hp, dtype, tol, kern, args, jac, uniq, name, timed, table=rows):
        """Hold kern(*args) against its plain version (Jacobians on the slots
        `uniq` whose winner is no tie) and note the error in `table`; hold
        both launch paths to the wrapper's output bit for bit; with `timed`,
        add the row's times."""
        plain = kernels.PLAIN[kern]
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        path = paths_check(kern, args, got, name, dtype)
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
        row["path"] = path
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
        nk = args[4].shape[1 if single else 2] if jac else n
        ops = Bk * Sx * L * O * T * (P * _OPS_PER_PIECE + (nk * _OPS_PER_JAC if jac else 0))
        moved = nbytes(*args, *outs)
        b_mem, b_ops = moved / peak_bw * 1e3, ops / peak_f32 * 1e3
        row.update({
            "name": name, "wrapper": kern.__name__, "route": "cuda",
            "source": "armour_tpu_torch/csrc/collision_bank.cu",
            "ms": time_ms(torch, lambda: kern(*args)),
            "plain_ms": time_ms(torch, lambda: plain(*args), reps=20, warmup=2),
            # the device alone: 20 calls in one CUDA graph, as a kept program replays them
            "graph_ms": graph_ms(lambda: kern(*args)),
            "plain_graph_ms": graph_ms(lambda: plain(*args), reps=3),
            "bytes": moved, "ops": ops,
            "bound_ms": max(b_mem, b_ops), "bound_by": "bytes" if b_mem >= b_ops else "operations",
            "library_ms": None, "floor_ms": floor_ms,
            "shapes": {"B": Bk, "S": Sx, "n": nk, "P": P, "L": L, "O": O, "T": T},
            # the streaming layout the launch took: start groups, groups a block, blocks
            "grid": kernels.stream_grid(Sx, L, O, T, jac, hp.dpos.element_size())
            if path == "stream" else None,
        })
        emit({"phase": "kernel_time", **{k: row[k] for k in
              ("name", "path", "ms", "plain_ms", "graph_ms", "plain_graph_ms", "bytes",
               "bound_ms", "floor_ms", "bound_by", "shapes", "grid")}})

    def bit_view(x):
        return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)

    def paths_check(kern, args, got, name, dtype):
        """The launch's own choice and both forced paths, through the private
        launchers (no count), against the wrapper's output bit for bit;
        returns the path the launch chose.  A bank whose rows the small-grid
        path cannot stage streams when that path is forced: it is named, and
        not counted as a check of both paths."""
        single = kern is kernels.fused_collision_value_jac
        want = got if isinstance(got, tuple) else (got,)
        same, ran = {}, {}
        for path in (None, *kernels.PATHS):
            if single:
                g1, J1, ran[path] = kernels._launch_value_jac_multi(
                    *args[:3], args[3][:, None].contiguous(), args[4][:, None].contiguous(),
                    path=path)
                out = (g1[:, 0], J1[:, 0])
            elif kern is kernels.fused_collision_value_jac_multi:
                *out, ran[path] = kernels._launch_value_jac_multi(*args, path=path)
            else:
                *out, ran[path] = kernels._launch_values_multi(*args, path=path)
            torch.cuda.synchronize()
            same[path or "auto"] = all(torch.equal(bit_view(a), bit_view(b))
                                       for a, b in zip(out, want))
        both = ran["small"] == "small"
        emit({"phase": "kernel_paths", "kernel": name, "dtype": str(dtype)[6:],
              "chosen": ran[None], "bits_equal": same, "both_paths": both,
              **({} if both else {"small_path": "not taken: the bank's rows are not "
                                                "16-byte aligned or its tile exceeds a block"})})
        assert all(same.values()), f"{name}: the launch paths disagree with the wrapper {same}"
        assert ran["stream"] == "stream", ran
        return ran[None]

    def grouping_check(dtype, tol, args, outs, split):
        """One launch at S starts against two launches of the same kernel,
        at the first ``split`` starts and at the rest: a start's outputs do
        not depend on the starts beside it, so they should be the same bits;
        any slot that differs is printed, and must lie within ``tol``.  With
        dc in ``args`` the value + Jacobian kernel, else the values-only one."""
        jac = len(args) == 5
        kern = kernels.fused_collision_value_jac_multi if jac else kernels.fused_collision_values_multi
        c = args[3]
        parts = [kern(*args[:3], *(x[:, sl].contiguous() for x in args[3:]))
                 for sl in (slice(0, split), slice(split, None))]
        if not jac:
            parts = [(part,) for part in parts]
        torch.cuda.synchronize()
        out = {"phase": "kernel_grouping", "kernel": kern.__name__, "dtype": str(dtype)[6:],
               "S": c.shape[1], "starts_per_launch": [split, c.shape[1] - split]}
        for i, label in enumerate(("g", "J")[:len(outs)]):
            one, two = outs[i], torch.cat([parts[0][i], parts[1][i]], dim=1)
            differ = one != two
            out[label] = {"slots_differing": int(differ.sum()),
                          "max_abs_diff": float((one - two).abs().max()),
                          "first_differing": differ.nonzero()[:10].tolist()}
            assert out[label]["max_abs_diff"] <= tol, \
                f"S={c.shape[1]}: one launch against {split} + the rest: {label} {out[label]}"
        out["bits_equal"] = all(out[label]["slots_differing"] == 0 for label in ("g", "J")[:len(outs)])
        emit(out)

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
        # more starts than one start group holds (4 with the Jacobian, 16
        # without): ONE launch, each group's blocks writing at their offsets
        c_many, dc_many = kernel_layout(*prob.links.slice_with_jac_multi(
            torch.as_tensor(K_many_np, dtype=dtype, device=dev))[::2])
        many = (hp.A, hp.dpos, hp.dneg, c_many, dc_many)
        kernels.reset_launch_counts()
        g_many, J_many = kernels.fused_collision_value_jac_multi(*many)
        assert kernels.launch_counts()["fused_collision_value_jac_multi"] == 1
        check_and_time(hp, dtype, tol, kernels.fused_collision_value_jac_multi, many, True,
                       kernels.tie_mask(hp.A, hp.dpos, hp.dneg, c_many, tol=1e-5), many_name,
                       timed=dtype == torch.float32)
        grouping_check(dtype, tol, many, (g_many, J_many), split=8)
        c_many_pool = kernel_layout(prob.links.slice_with_jac_multi(
            torch.as_tensor(K_many_pool_np, dtype=dtype, device=dev))[0])
        kernels.reset_launch_counts()
        g_many_pool = kernels.fused_collision_values_multi(hp.A, hp.dpos, hp.dneg, c_many_pool)
        assert kernels.launch_counts()["fused_collision_values_multi"] == 1
        check_and_time(hp, dtype, tol, kernels.fused_collision_values_multi,
                       (hp.A, hp.dpos, hp.dneg, c_many_pool), False, unique, many_pool_name,
                       timed=dtype == torch.float32)
        # its 26 starts: groups of 13 side by side in a block, against
        # launches of the first 16 (one group) and the last 10
        grouping_check(dtype, tol, (hp.A, hp.dpos, hp.dneg, c_many_pool), (g_many_pool,), split=16)
        del many, c_many, dc_many, g_many, J_many, c_many_pool, g_many_pool
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
    # inside the kernel), the second with 9 starts (three start groups, one launch)
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
        kernels.reset_launch_counts()
        check_and_time(hp, torch.float32, 2e-6, kernels.fused_collision_value_jac_multi,
                       (hp.A, hp.dpos, hp.dneg, c, dc), True, uniq, f"value_jac_multi[{label}]",
                       timed=False, table=small)
        check_and_time(hp, torch.float32, 2e-6, kernels.fused_collision_values_multi,
                       (hp.A, hp.dpos, hp.dneg, c), False, uniq, f"values_multi[{label}]",
                       timed=False, table=small)
        assert kernels.launch_counts() == dict(zero_counts, fused_collision_value_jac_multi=1,
                                               fused_collision_values_multi=1), \
            f"{label}: {kernels.launch_counts()}"
    del hp, A, c, dc, uniq

    # ---- 3b. the rollout kernel against its plain version ---------------
    rollout_phase(torch, dev, rows, peak_bw, peak_f32, ptxas_rows=rptxas)
    rows["fused_rollout"].update(floor_ms=floor_ms, path=None)   # one path: a block per world
    torch.cuda.empty_cache()

    rows["fused_collision_value_jac_multi"]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[many_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows[wide_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:166"
    rows["fused_collision_values_multi"]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows[pool_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows[many_pool_name]["replaces"] = "armour_tpu/collision/pallas_kernel.py:225"
    rows["fused_collision_value_jac"]["replaces"] = "armour_tpu/collision/pallas_kernel.py:85"

    # ---- 4. main path ----------------------------------------------------
    planner = ArmourPlanner(spec, cfg, dtype=torch.float32, device=dev)
    passes = cfg.nlp_outer_iters * cfg.nlp_inner_iters + 1
    main_name = "fused_collision_value_jac_multi"

    def same_bits(a, b):
        """k, feasible and max_violation of two plans equal to the bit."""
        return {f: torch.equal(*(getattr(r, f).contiguous().view(torch.int32)
                                 if getattr(r, f).dtype == torch.float32 else getattr(r, f)
                                 for r in (a, b)))
                for f in ("k", "feasible", "max_violation")}

    def run_point(probs, label, reps=2):
        """plan_batch through the programs kept per (B, bucket): the first
        call (captures included) and ``reps`` replays, each held to the
        eager plan_batch to the bit with 65 launches; then the build and
        solve split of one more replay (device synchronised between)."""
        args = (probs.q0, probs.qd0, probs.qdd0, probs.q_des, probs.zonos, probs.masks)
        eager_s, ref = wall(torch, lambda: planner.plan_batch(*args, eager=True), 1)
        secs, deltas, res, equal = [], [], None, []
        for _ in range(reps + 1):
            kernels.reset_launch_counts()
            dt, res = wall(torch, lambda: planner.plan_batch(*args), 1)
            deltas.append(kernels.launch_counts())
            secs.append(dt)
            equal.append(same_bits(res, ref))
        for d in deltas:
            assert d[main_name] == passes, f"{label}: {d} launches, expected {passes}"
        assert all(all(e.values()) for e in equal), f"{label}: kept plan against eager {equal}"
        cache = planner.batch_programs.stats()
        cap = {str(key): sum(st.capture_ms for st in p.steps if isinstance(st, CapturedStep))
               for key, p in planner.batch_programs.entries.items()}
        marks = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, prob = planner.run_program(*args, marks=marks)
        t_build, t_solve = marks["built"] - t0, marks["solved"] - marks["built"]
        feas = res.feasible.cpu().numpy()
        k = res.k.cpu().numpy()
        assert np.all(np.isfinite(k[feas])) and np.all(np.isnan(k[~feas]))
        assert np.all(np.abs(k[feas]) <= 1.0)
        sec = statistics.median(secs[1:])
        emit({"phase": "main_path", "point": label, "batch": B, "T": cfg.num_time_steps,
              "first_call_s": secs[0], "capture_ms": cap,
              "seconds_per_batch": sec, "seconds_runs": secs[1:], "eager_s": eager_s,
              "plans_per_s": B / sec, "feasible_fraction": float(feas.mean()),
              "bits_equal_to_eager": True, "program_cache": cache,
              "bucket": int(prob.hp.dpos.shape[-2]), "launches_per_plan_batch": deltas[-1],
              "build_s": t_build, "solve_s": t_solve,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        return res, prob, deltas[-1]

    torch.cuda.reset_peak_memory_stats()
    res8, prob8, counts8 = run_point(probs8, "8obs")
    for name, r in rows.items():
        if name != "fused_rollout":     # its launches are the closed loop's (phase 6)
            r["launches"] = counts8[r["wrapper"]]
    _, _, counts40 = run_point(probs40, "40obs")
    rows[wide_name]["launches"] = counts40[main_name]

    batch1_rows = latency_phase(torch, dev, check_and_time, rows, probs8, probs40)

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
    planner.batch_programs.clear()       # prob8's buffers stay until it goes


    # ---- 5. the other planner modes at full width --------------------------
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

    # more starts than one start group of the main kernel holds (12: three
    # groups of 4) through the same entry point: still one launch per pass
    _, _, out = run_mode(f"{S_many}starts",
                         ArmourPlanner(spec, dataclasses.replace(cfg, nlp_num_starts=S_many),
                                       dtype=torch.float32, device=dev), args8, {main_name: passes})
    assert out["feasible_fraction"] > 0.0, out
    rows[many_name]["launches"] = out["launches_per_plan_batch"][main_name]
    emit(out)

    tau = 1e-3
    smooth_pl = ArmourPlanner(spec, dataclasses.replace(cfg, smooth_collision_tau=tau),
                              dtype=torch.float32, device=dev)
    _, _, out = run_mode("smooth", smooth_pl, args8, {"fused_collision_values_multi": 1})
    rows[pool_name]["launches"] = out["launches_per_plan_batch"]["fused_collision_values_multi"]
    emit(dict(out, tau=tau, pool=S_pool))
    # the same at 12 starts: a pool of 26 candidates, still one launch
    smooth_pl = ArmourPlanner(spec, dataclasses.replace(cfg, smooth_collision_tau=tau,
                                                        nlp_num_starts=S_many),
                              dtype=torch.float32, device=dev)
    _, _, out = run_mode(f"smooth_{S_many}starts", smooth_pl, args8,
                         {"fused_collision_values_multi": 1})
    rows[many_pool_name]["launches"] = out["launches_per_plan_batch"]["fused_collision_values_multi"]
    emit(dict(out, tau=tau, pool=S_many_pool))
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
    # the whole 1,000-step move (robust controller, RK4 at 5e-4 s) as ONE
    # launch of the rollout kernel
    sim = SimConfig()
    n_steps = int(round(sim.t_move / sim.plant_dt))
    rng_true = np.random.default_rng(0)
    true = TrueParams(rng_true.uniform(*sim.uncertain_mass_range, (B, spec.n_joints)),
                      rng_true.uniform(*sim.uncertain_mass_range, (B, spec.n_joints)))
    feas8 = res8.feasible
    k8 = torch.where(feas8[:, None], res8.k, 0.0).double().cpu().numpy()   # infeasible: k = 0 brakes
    traj = TrajParams(probs8.q0, probs8.qd0, probs8.qdd0, cfg.k_range * k8, np.zeros(B))
    track_kw = dict(duration=cfg.duration, controller="robust", device=dev, dtype=torch.float32)

    def move():
        return rollout(spec, sim, probs8.q0, probs8.qd0, traj, true, **track_kw)

    move()                                                                   # warm-up
    rk.reset_launch_counts()
    t_roll, (q_end, qd_end, log) = wall(torch, move, 1)
    track_launches = rk.launch_counts()["fused_rollout"]
    assert track_launches == 1, f"track: {track_launches} rollout kernel launches per move"
    rows["fused_rollout"]["launches"] = track_launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_traced, _ = wall(torch, move, 1)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.device_time for e in dev_events) * 1e-6
    calls = count_tensor_calls(move)
    assert dev_events, "the profiler recorded no device activity"
    pos_err = (log.q - log.q_ref).abs().amax(dim=(1, 2))                    # (B,)
    vel_err = (log.qd - log.qd_ref).abs().amax(dim=(1, 2))
    assert bool(torch.isfinite(log.q).all()) and bool(torch.isfinite(log.u).all())
    assert log.q.shape == (B, int(round(sim.t_move / sim.check_dt)), n), log.q.shape
    assert float(pos_err.max()) <= spec.qe, f"track: position error {float(pos_err.max())} > {spec.qe}"
    assert float(vel_err.max()) <= 2 * spec.ultimate_bound, f"track: velocity error {float(vel_err.max())}"
    # the same move kept as one graph, the packing and the launch, as the
    # battery driver's move-and-check stage and the episode program keep it
    f32 = torch.float32
    on_dev = [torch.as_tensor(x, dtype=f32, device=dev) for x in (probs8.q0, probs8.qd0)]
    traj_d = TrajParams(*(torch.as_tensor(x, dtype=f32, device=dev) for x in traj))
    true_d = TrueParams(*(torch.as_tensor(x, dtype=f32, device=dev) for x in true))
    kept_move = KeptFunction(lambda q, qd, tr, tp: rollout(spec, sim, q, qd, tr, tp, **track_kw), dev)
    rk.reset_launch_counts()
    kept_out = kept_move(*on_dev, traj_d, true_d)                           # warm-up and capture
    t_kept, _ = wall(torch, lambda: kept_move(*on_dev, traj_d, true_d), 3)
    kept_launches = rk.launch_counts()["fused_rollout"]
    assert kept_launches == 4, f"track: {kept_launches} launches in 4 calls of the kept move"
    for a, b in zip((kept_out[0], kept_out[1], *kept_out[2]), (q_end, qd_end, *log)):
        assert torch.equal(a, b), "track: the kept move differs from the bare move"
    with torch.profiler.profile(activities=acts) as prof_k:
        t_kept_traced, _ = wall(torch, lambda: kept_move(*on_dev, traj_d, true_d), 1)
    busy_k = sum(e.device_time for e in prof_k.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) * 1e-6
    kept_move_capture_ms = kept_move.step.capture_ms
    kept_move.release()
    n_log = log.q.shape[1]
    obs_log = ObstacleSet(
        torch.as_tensor(probs8.zonos, dtype=torch.float32, device=dev)[:, None].expand(-1, n_log, -1, -1, -1),
        torch.as_tensor(probs8.masks, device=dev)[:, None].expand(-1, n_log, -1))
    hits = arm_collision_check(spec, log.q, obs_log).any(dim=1)             # (B,)
    assert not bool(hits[feas8].any()), "track: a feasible world's executed motion hits an obstacle"
    emit({"phase": "track", "batch": B, "steps": n_steps, "plant_dt": sim.plant_dt,
          "controller": "robust", "dtype": "float32", "seconds_per_move": t_roll,
          "ms_per_move": t_roll * 1e3, "rollout_kernel_launches": track_launches,
          "device_kernels_per_move": len(dev_events), "host_tensor_calls_per_move": calls,
          "traced_move": {"wall_s": t_traced, "device_busy_s": busy_s,
                          "device_idle_share": 1.0 - busy_s / t_traced},
          "kept_move": {"equal_to_bare": True, "launches_per_call": 1, "ms_per_move": t_kept * 1e3,
                        "capture_ms": kept_move_capture_ms,
                        "traced": {"wall_s": t_kept_traced, "device_busy_s": busy_k,
                                   "device_idle_share": 1.0 - busy_k / t_kept_traced}},
          "max_pos_err": float(pos_err.max()), "qe": spec.qe,
          "max_vel_err": float(vel_err.max()), "vel_bound": 2 * spec.ultimate_bound,
          "feasible_worlds": int(feas8.sum()), "collisions_feasible": int(hits[feas8].sum()),
          "collisions_infeasible_k0": int(hits[~feas8].sum())})
    del log, obs_log, prof, dev_events, prof_k, kept_out

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
    # the card's rollout is the kernel, the CPU's the plain version
    rk.reset_launch_counts()
    ends = [rollout(spec, sim20, probs4.q0, probs4.qd0, traj4, true4, duration=cfg.duration,
                    device=d, dtype=torch.float64)[0].cpu() for d in (dev, "cpu")]
    assert rk.launch_counts()["fused_rollout"] == 1, rk.launch_counts()
    end_diff = float((ends[0] - ends[1]).abs().max())
    assert end_diff <= 1e-9, f"rollout: |q_end card - q_end CPU| = {end_diff}"
    emit({"phase": "card_vs_cpu", "path": "rollout", "worlds": 4, "steps": 20,
          "dtype": "float64", "max_abs_q_end_diff": end_diff, "atol": 1e-9,
          "card_rollout_kernel_launches": 1})

    # ---- 8-10. self-intersection, its card-vs-CPU parity, scale-out --------
    del res8, prob8
    torch.cuda.empty_cache()
    ext_rows = extension_phases(torch, dev, check_and_time, rows, probs8, probs40,
                                T=cfg.num_time_steps)

    # ---- 10b. the guidance's kept programs ---------------------------------
    torch.cuda.empty_cache()
    guidance_phase(torch, dev)

    # ---- 11-14. the receding-horizon episode paths -------------------------
    del probs40
    torch.cuda.empty_cache()
    battery_row = episode_phases(torch, dev, check_and_time, rows, out_dir)

    # ---- 15-17. the reference-schema export, the figures, the grasp example ----
    torch.cuda.empty_cache()
    tool_rows = tool_phases(torch, dev, check_and_time, rows, out_dir)

    # ---- 18-20. graphs against eager, the controller sweep, the simple example ----
    torch.cuda.empty_cache()
    graph_phases(torch, dev, probs8, problem_set(cfg, B, n_obs=40, seed=7, device=dev), out_dir)
    torch.cuda.empty_cache()
    entry_point_phases(torch, dev, out_dir)

    # ---- 21-22. the ARMOUR-ARMTD comparison, the scaling rows ------------
    torch.cuda.empty_cache()
    comparison_phases(torch, dev, out_dir)

    # ---- tail ------------------------------------------------------------
    order = ("fused_collision_value_jac_multi", "fused_collision_values_multi",
             "fused_collision_value_jac", "fused_rollout", pool_name, many_name, many_pool_name,
             wide_name, *batch1_rows, *ext_rows,
             battery_row, *tool_rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "graph_ms", "plain_graph_ms", "bound_ms", "bound_by", "library_ms",
            "floor_ms", "path")
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
