"""The CUDA graphs of the solver iteration and of the RK4 step of
``rollout_plain``, the kept plan programs, the kept episode steps
(``EpisodeRunner.run_batch``'s ``EpisodeProgram``, a move captured through
a ``KeptFunction``), the guidance's kept programs (the IK, the
end-effector positions, the mesh refinement's FK, the configuration and
optimization waypoints; the battery's stage cache) and the kept sharded
planning step (``sharded_plan_step`` on an in-process NCCL group of one
rank) against the same steps run op by op, on the card.

Runs only where a CUDA device is present (marker ``cuda``; elsewhere each
test skips).  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py -q

Graph and eager run the same kernels on the same inputs, so every result
is held to the bit (k, max_violation and the rollout's states and log as
bit patterns, NaN where both are NaN; feasible equal).  The collision
kernels' launch counters count what runs: a capture adds nothing, each
replay adds what it captured, so a graphed ``plan_batch`` still counts
exactly one launch per constraint pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from armour_tpu_torch.collision import kernels
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import GraspConfig, PlannerConfig, SimConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.planner.rotatotope import rotatotope_planner
from armour_tpu_torch.problems import Q_HOME, problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import harness
from armour_tpu_torch.sim import rollout_kernel as rk
from armour_tpu_torch.sim.agent import CONTROLLERS, TrajParams, TrueParams, rollout, rollout_plain
from armour_tpu_torch.utils.graphs import CapturedStep, KeptFunction

pytestmark = pytest.mark.cuda

SPEC = kinova_gen3_spec()
CFG = PlannerConfig(num_time_steps=64)
B = 32
MAIN = "fused_collision_value_jac_multi"
PASSES = CFG.nlp_outer_iters * CFG.nlp_inner_iters + 1
Q_SI = (0.0, 0.5, 0.0, -0.5, 0.0, 0.5, 0.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py")
    return torch.device("cuda")


def _bits(x):
    x = x.detach().cpu().contiguous()
    if not x.is_floating_point():
        return x
    return x.view({torch.float64: torch.int64, torch.float32: torch.int32}[x.dtype])


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _planner(mode, device, dtype=torch.float32):
    kw = {"orig": dict(traj_type="orig"),
          "grasp": dict(grasp=GraspConfig(object_mass=0.2, u_s=0.6, surf_rad=0.03)),
          "bernstein+si": dict(self_intersection=True)}.get(mode, {})
    cfg = {"12starts": dataclasses.replace(CFG, nlp_num_starts=12),
           "smooth": dataclasses.replace(CFG, smooth_collision_tau=1e-3)}.get(mode, CFG)
    if mode == "rotatotope":
        return rotatotope_planner(SPEC, cfg, dtype, device=device)
    return ArmourPlanner(SPEC, cfg, dtype, device=device, **kw)


def _worlds(mode, n_obs=8, seed=0):
    if mode == "grasp":
        q0 = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0]) + \
            np.random.default_rng(0).uniform(-0.05, 0.05, (B, 7))
        zonos = np.zeros((B, CFG.max_obstacles, 4, 3))
        zonos[:, 0, 0], zonos[:, 0, 1:] = 5.0, 0.05 * np.eye(3)
        masks = np.zeros((B, CFG.max_obstacles), bool)
        masks[:, 0] = True
        z = np.zeros((B, 7))
        return q0, z, z, q0 + 0.3 * CFG.k_range, zonos, masks
    p = problem_set(CFG, B, n_obs=n_obs, seed=seed, device="cuda",
                    q_center=Q_SI if mode == "bernstein+si" else Q_HOME)
    if mode == "bernstein+si":
        p = p._replace(qd0=np.zeros_like(p.q0), qdd0=np.zeros_like(p.q0))
    return tuple(p)


def _plan_both(pl, args, k_rand):
    out = {}
    for eager in (True, False):
        kernels.reset_launch_counts()
        out[eager] = (pl.plan_batch(*args, k_rand=k_rand, eager=eager), kernels.launch_counts())
        torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("mode", ["default", "40obs", "orig", "12starts", "smooth", "grasp",
                                  "bernstein+si", "rotatotope"])
def test_graphed_plan_batch_equals_eager_to_the_bit(card, mode):
    pl = _planner(mode, card)
    args = _worlds(mode, *((40, 7) if mode == "40obs" else ()))
    k_rand = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.6, 0.6, (B, max(pl.cfg.nlp_num_starts - 2, 1), 7)), dtype=torch.float32, device=card)
    out = _plan_both(pl, args, k_rand)
    (eager, c_eager), (graph, c_graph) = out[True], out[False]
    assert torch.equal(eager.feasible, graph.feasible)
    assert _same(eager.k, graph.k) and _same(eager.max_violation, graph.max_violation)
    assert _same(eager.cost, graph.cost)
    # a capture adds no launch; each replay adds what it captured
    assert c_graph == c_eager
    if mode == "smooth":
        assert c_graph == {MAIN: 0, "fused_collision_values_multi": 1, "fused_collision_value_jac": 0}
    else:
        # any start count is one launch per pass (12 starts: three start groups)
        assert c_graph == {MAIN: PASSES, "fused_collision_values_multi": 0,
                           "fused_collision_value_jac": 0}


def test_consecutive_solves_on_different_problems_each_equal_eager(card):
    """A graph never outlives its solve: two different world sets planned
    in a row each give the eager plan's bits."""
    pl = _planner("default", card)
    for seed in (0, 3):
        args = problem_set(CFG, B, n_obs=8, seed=seed, device=card)
        k_rand = pl.random_starts(B, torch.Generator(device=card).manual_seed(seed))
        out = _plan_both(pl, args, k_rand)
        assert torch.equal(out[True][0].feasible, out[False][0].feasible)
        assert _same(out[True][0].k, out[False][0].k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_graphed_rollout_equals_eager_to_the_bit(card, controller, dtype):
    rng = np.random.default_rng(0)
    n = 16
    q0, qd0 = rng.uniform(-1, 1, (n, 7)), rng.uniform(-0.3, 0.3, (n, 7))
    traj = TrajParams(q0, qd0, rng.uniform(-0.5, 0.5, (n, 7)),
                      rng.uniform(-1, 1, (n, 7)) * CFG.k_range, np.zeros(n))
    scale = rng.uniform(0.9, 1.1, (n, 7))
    sim = dataclasses.replace(SimConfig(), t_move=200 * SimConfig().plant_dt)
    noise = torch.as_tensor(rng.normal(scale=1e-4, size=(200, 2, n, 7)), dtype=dtype, device=card)
    runs = [rollout_plain(SPEC, sim, q0, qd0, traj, TrueParams(scale, scale), controller=controller,
                          noise=noise, device=card, dtype=dtype, eager=eager) for eager in (True, False)]
    (qa, qda, la), (qb, qdb, lb) = runs
    assert _same(qa, qb) and _same(qda, qdb)
    for name in la._fields:
        assert _same(getattr(la, name), getattr(lb, name)), name
    assert la.q.shape == (n, int(round(sim.t_move / sim.check_dt)), 7)


def _plan_worlds(mode, card):
    """Four worlds of bucket 8, then world 1 with four far boxes in slots
    8-11 (bucket 16), then world 2 again (bucket 8)."""
    q0, qd0, qdd0, q_des, zonos, masks = _worlds(mode)
    worlds = [(q0[i], qd0[i], qdd0[i], q_des[i], ObstacleSet(zonos[i], masks[i])) for i in range(4)]
    z, m = np.array(zonos[1], copy=True), np.array(masks[1], copy=True)
    z[8:12] = 0.0
    z[8:12, 0] = 5.0
    z[8:12, 1:] = 0.05 * np.eye(3)
    m[8:12] = True
    worlds.append((q0[1], qd0[1], qdd0[1], q_des[1], ObstacleSet(z, m)))
    return worlds + [worlds[2]]


@pytest.mark.parametrize("mode", ["default", "orig", "smooth", "grasp"])
def test_cached_plan_equals_eager_plan_to_the_bit(card, mode):
    """``plan`` through its program kept per shape key against the eager
    ``plan`` (op by op, no program), across worlds and a bucket change; a
    replay counts the launches that run."""
    pl = _planner(mode, card)
    if mode == "smooth":
        expect = {MAIN: 0, "fused_collision_values_multi": 1, "fused_collision_value_jac": 0}
    else:
        expect = {MAIN: PASSES, "fused_collision_values_multi": 0, "fused_collision_value_jac": 0}
    for i, world in enumerate(_plan_worlds(mode, card)):
        k_rand = pl.random_starts(1, torch.Generator(device=card).manual_seed(i))[0]
        ref = pl.plan(*world, k_rand=k_rand, eager=True)
        kernels.reset_launch_counts()
        got = pl.plan(*world, k_rand=k_rand)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == expect, i
        assert bool(got.feasible) == bool(ref.feasible), i
        assert _same(got.k, ref.k) and _same(got.max_violation, ref.max_violation), i
        assert _same(got.cost, ref.cost) and _same(got.torque_radius, ref.torque_radius), i
    stats = pl.programs.stats()
    assert (stats["misses"], stats["hits"]) == (2, 4)
    # per key: the build, the first bank pass, the iteration, the outer
    # update and the verification
    assert stats["captures"] == 10


def test_cached_plan_frees_its_pools_on_eviction(card):
    pl = _planner("default", card)
    worlds = _plan_worlds("default", card)
    pl.plan(*worlds[0])                     # the side stream and the constants, once
    pl.programs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    q0, qd0, qdd0, q_des, obs = worlds[0]
    first = None
    for n_live in (8, 16, 24, 32, 40):      # five keys through a cache of four
        z, m = np.array(obs.zonos, copy=True), np.array(obs.mask, copy=True)
        z[8:n_live, 0], z[8:n_live, 1:] = 5.0, 0.05 * np.eye(3)
        m[:n_live] = m[:n_live] | (np.arange(n_live) >= 8)
        pl.plan(q0, qd0, qdd0, q_des, ObstacleSet(z, m))
        first = first or next(iter(pl.programs.entries.values()))
    assert pl.programs.stats()["evictions"] == 1 and first.steps == []
    pl.programs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    assert abs(after - before) <= 0.05 * before, (before, after)


def test_repeated_plans_and_rollouts_hold_no_memory(card):
    """Each solve's and each rollout's capture is released when its loop
    ends, so planning and moving again and again keeps the allocated memory
    flat (a battery once grew by about 1 GB per iteration)."""
    pl = _planner("default", card)
    args = _worlds("default")
    rng = np.random.default_rng(0)
    traj = TrajParams(args[0], args[1], args[2], rng.uniform(-1, 1, (B, 7)) * CFG.k_range, np.zeros(B))
    sim = dataclasses.replace(SimConfig(), t_move=20 * SimConfig().plant_dt)
    ones = np.ones((B, 7))

    def once():
        pl.plan_batch(*args)
        rollout_plain(SPEC, sim, args[0], args[1], traj, TrueParams(ones, ones), device=card)
        torch.cuda.synchronize()

    once()
    once()
    base = torch.cuda.memory_allocated()
    for _ in range(4):
        once()
    assert torch.cuda.memory_allocated() <= base + (1 << 20), (base, torch.cuda.memory_allocated())


def _with_kept(pl, args, n_kept):
    """``args`` (B worlds of 40 live obstacles) with ``n_kept`` obstacles
    left to each world by the planner's culling: the extra kept ones are
    masked out, and dropped slots take copies of a kept one where a world
    keeps fewer (a world that keeps none stays so).  Chooses the culled
    bucket."""
    q0, qd0, qdd0, q_des, zonos, masks = args
    _, _, aabb_c, aabb_r = pl.reachable_sets(q0, qd0, qdd0)
    z = torch.as_tensor(zonos, dtype=pl.dtype, device="cuda")
    keep = pl.cull_keep(aabb_c, aabb_r, z, torch.as_tensor(masks, device="cuda")).cpu().numpy()
    z, m = np.array(z.cpu().numpy(), copy=True), np.array(masks, copy=True)
    for w in range(len(keep)):
        kept, dropped = np.nonzero(keep[w])[0], np.nonzero(~keep[w] & m[w])[0]
        m[w, kept[n_kept:]] = False
        if len(kept):
            z[w, dropped[: max(n_kept - len(kept), 0)]] = z[w, kept[0]]
    return (q0, qd0, qdd0, q_des, z, m)


def _bucket_worlds(pl, poses):
    """Three world sets of culled buckets 8, 16 and 24: the 40 obstacles of
    the worlds of seed 7 around the start states and goals of ``poses``,
    with 6, 12 and 20 kept per world."""
    base = (*poses[:4], *_worlds("default", 40, 7)[4:])
    return [_with_kept(pl, base, n) for n in (6, 12, 20)]


@pytest.mark.parametrize("mode", ["default", "orig", "12starts", "smooth", "grasp", "bernstein+si"])
def test_kept_plan_batch_equals_eager_across_world_sets_and_buckets(card, mode):
    """``plan_batch`` through its programs kept per (B, bucket): the first
    call and the replays of each key, across two world sets at one key and
    the culled bucket sequence 16 -> 8 -> 16, against the eager plan to the
    bit; every plan counts the launches that run, and a replay captures
    nothing."""
    pl = _planner(mode, card)
    if mode == "smooth":
        expect = {MAIN: 0, "fused_collision_values_multi": 1, "fused_collision_value_jac": 0}
    else:
        expect = {MAIN: PASSES, "fused_collision_values_multi": 0, "fused_collision_value_jac": 0}
    plain = _worlds(mode)                                   # bucket 8: one program
    other = _worlds(mode, seed=3) if mode != "grasp" else \
        tuple(np.asarray(x) + 0.02 * (i in (0, 3)) for i, x in enumerate(plain))
    b8, b16, _ = _bucket_worlds(pl, plain)
    seq = [plain, other, plain, b16, b8, b16]
    for i, args in enumerate(seq):
        k_rand = pl.random_starts(B, torch.Generator(device=card).manual_seed(i))
        ref = pl.plan_batch(*args, k_rand=k_rand, eager=True)
        before = pl.batch_programs.stats()
        kernels.reset_launch_counts()
        got = pl.plan_batch(*args, k_rand=k_rand)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == expect, i
        assert torch.equal(got.feasible, ref.feasible), i
        assert _same(got.k, ref.k) and _same(got.max_violation, ref.max_violation), i
        assert _same(got.cost, ref.cost) and _same(got.torque_radius, ref.torque_radius), i
        after = pl.batch_programs.stats()
        if i in (1, 2, 5):                                   # a key met before: replays only
            assert after["captures"] == before["captures"] and after["misses"] == before["misses"], i
    keys = list(pl.batch_programs.entries)
    assert (B, 8) in keys and (B, CFG.max_obstacles, "reach") in keys, keys
    assert len({k[2] for k in keys if len(k) == 3} - {"reach"}) == 2, keys


def test_repeated_batched_plans_over_three_buckets_hold_no_memory(card):
    """Once every bucket's program is kept, 20 more batched plans over the
    three buckets allocate nothing that stays."""
    pl = _planner("default", card)
    sets = _bucket_worlds(pl, _worlds("default"))
    for args in sets * 2:
        pl.plan_batch(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for i in range(20):
        pl.plan_batch(*sets[i % 3])
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base + (1 << 20), (base, torch.cuda.memory_allocated())
    assert pl.batch_programs.stats()["misses"] == 4            # the stage and three buckets
    pl.batch_programs.clear()


def _episode(dtype, card, max_iterations=3, B=8):
    """A runner at T=32 and B worlds of 8obs with goals 0.3-0.6 rad from
    their starts (several iterations to reach), as run_batch takes them."""
    cfg = dataclasses.replace(CFG, num_time_steps=32)
    p = problem_set(cfg, B, n_obs=8, seed=0, device=card)
    goals = p.q0 + 0.3 * np.sign(p.q_des - p.q0) + 0.3 * (p.q_des - p.q0) / cfg.k_range
    runner = harness.EpisodeRunner(SPEC, cfg, SimConfig(max_iterations=max_iterations), dtype,
                                   device=card)
    return runner, (p.q0, goals, p.zonos, p.masks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kept_run_batch_equals_eager_on_the_card(card, dtype):
    """Three iterations of the kept episode (the pre-plan and post-plan
    graphs around the kept plan program) against ``run_batch(eager=True)``:
    every summary field to the bit; 65 main-kernel launches and one rollout
    launch per iteration; both steps captured once."""
    out, launches = {}, {}
    for eager in (True, False):
        runner, worlds = _episode(dtype, card)
        kernels.reset_launch_counts()
        rk.reset_launch_counts()
        out[eager] = runner.run_batch(*worlds, torch.Generator(device=card).manual_seed(1), eager=eager)
        torch.cuda.synchronize()
        launches[eager] = (kernels.launch_counts()[MAIN], rk.launch_counts()["fused_rollout"])
        if not eager:
            stats = runner.programs.stats()
            assert (stats["misses"], stats["hits"], stats["captures"]) == (1, 2, 2), stats
    for name in out[True]._fields:
        if getattr(out[True], name) is not None:
            assert _same(getattr(out[False], name), getattr(out[True], name)), name
    assert int(out[True].iterations.max()) == 3
    assert launches[False] == launches[True] == (3 * PASSES, 3), launches


def test_kept_run_batch_that_ends_early_equals_eager_on_the_card(card):
    """Every goal at its start, so every world ends before
    ``max_iterations``: the kept loop reads the done flag one iteration
    late (pinned memory and an event) and runs exactly one iteration after
    the last world ended, which changes nothing and gives its draws back.
    Two calls on one generator, as ``run_worlds`` makes them: each summary
    to the bit, the generator's state after each call, and the launches
    (one iteration more than op by op) against ``run_batch(eager=True)``."""
    max_it = 5
    out = {}
    for eager in (True, False):
        runner, (starts, _, zonos, masks) = _episode(torch.float32, card, max_iterations=max_it)
        gen = torch.Generator(device=card).manual_seed(2)
        calls = out[eager] = []
        for _ in range(2):
            kernels.reset_launch_counts()
            rk.reset_launch_counts()
            s = runner.run_batch(starts, starts, zonos, masks, gen, eager=eager)
            torch.cuda.synchronize()
            calls.append((s, (kernels.launch_counts()[MAIN], rk.launch_counts()["fused_rollout"]),
                          gen.get_state()))
    for (s_e, n_e, g_e), (s_k, n_k, g_k) in zip(out[True], out[False]):
        for name in s_e._fields:
            if getattr(s_e, name) is not None:
                assert _same(getattr(s_e, name), getattr(s_k, name)), name
        assert bool((s_e.goal_reached | s_e.collision | s_e.stopped).all())
        n = int(s_e.iterations.max())
        assert n < max_it - 1, n
        assert n_e == (n * PASSES, n) and n_k == ((n + 1) * PASSES, n + 1), (n, n_e, n_k)
        assert torch.equal(g_e, g_k)


def test_captured_move_equals_a_bare_launch_and_counts_each_replay(card):
    """The battery's move (robust, f32, 1,000 steps, noise) through a
    ``KeptFunction`` (packing and launch in one graph): every replay equal
    to a bare ``fused_rollout`` launch to the bit, one launch counted per
    call, the capture included."""
    args = _worlds("default")
    rng = np.random.default_rng(4)
    sim = SimConfig()
    n_steps = int(round(sim.t_move / sim.plant_dt))

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=card)

    traj = TrajParams(t(args[0]), t(args[1]), t(args[2]),
                      t(rng.uniform(-1, 1, (B, 7)) * CFG.k_range), t(np.zeros(B)))
    tp = TrueParams(t(rng.uniform(0.97, 1.03, (B, 7))), t(rng.uniform(0.97, 1.03, (B, 7))))
    noise = t(1e-4 * rng.standard_normal((n_steps, 2, B, 7)))

    def move(q, qd, traj, tp, noise):
        return rollout(SPEC, sim, q, qd, traj, tp, CFG.duration, noise=noise, device=card,
                       dtype=torch.float32)

    bare = move(traj.q0, traj.qd0, traj, tp, noise)
    kept = KeptFunction(move, card)
    rk.reset_launch_counts()
    for i in range(4):
        got = kept(traj.q0, traj.qd0, traj, tp, noise)
        torch.cuda.synchronize()
        assert rk.launch_counts()["fused_rollout"] == i + 1
        assert _same(got[0], bare[0]) and _same(got[1], bare[1]), i
        for a, b in zip(got[2], bare[2]):
            assert _same(a, b), i
    assert kept.step.graph is not None
    kept.release()


def _kept_against_eager(fn, args, card, calls=2):
    """``fn(*args)`` through a ``KeptFunction`` (the first call captures,
    later ones replay), each call's outputs against ``fn(*args)`` op by op
    to the bit; returns the kept function (captured) for its capture ms."""
    ref = fn(*args)
    kept = KeptFunction(fn, card)
    for i in range(calls):
        got = kept(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert _same(a, b), i
    assert kept.step.graph is not None
    return kept


@pytest.mark.parametrize("B, dtype", [(100, torch.float32), (1, torch.float64)],
                         ids=["B100-f32", "B1-f64"])
def test_kept_ik_equals_eager_to_the_bit(card, B, dtype):
    """The damped-least-squares IK (60 iterations, the position Jacobian
    by forward-mode tangents, the 3 x 3 SPD solve) kept as one graph: the
    battery's ``ik`` stage (B=100, f32) and the configuration waypoints'
    program (one row, f64)."""
    from armour_tpu_torch.dynamics.utility import ee_pose
    from armour_tpu_torch.planner.hlp import ik_to_position

    rng = np.random.default_rng(7)
    q = torch.as_tensor(np.array(Q_HOME) + rng.uniform(-0.5, 0.5, (B, 7)), dtype=dtype, device=card)
    targets = ee_pose(SPEC, q + 0.2)[1]
    targets[-1] = torch.tensor([3.0, 0.0, 0.5])           # out of reach
    kept = _kept_against_eager(lambda t, s: ik_to_position(SPEC, t, s), (targets, q), card)
    assert kept.step.capture_ms > 0.0
    kept.release()


def test_kept_ee_position_and_windows_fk_equal_eager_at_every_row_bucket(card):
    """The battery's ``ee`` stage (B=100, f32) and its mesh-refinement FK
    at each row bucket of ``fk_rows`` (1, 2, 4, ..., 64, 100), each kept
    as one graph, against op by op to the bit."""
    from armour_tpu_torch.dynamics.utility import ee_pose

    rng = np.random.default_rng(8)
    f32 = torch.float32
    q = torch.as_tensor(np.array(Q_HOME) + rng.uniform(-1, 1, (100, 7)), dtype=f32, device=card)
    _kept_against_eager(lambda x: (ee_pose(SPEC, x)[1],), (q,), card).release()
    log_q = torch.as_tensor(np.array(Q_HOME) + rng.uniform(-1, 1, (100, 50, 7)), dtype=f32, device=card)
    buckets = sorted({harness.fk_rows(F, 100) for F in range(1, 101)})
    assert buckets == [1, 2, 4, 8, 16, 32, 64, 100]
    for n in buckets:
        rows = torch.as_tensor(rng.permutation(100)[:n], device=card)
        _kept_against_eager(lambda lq, r: harness.windows_fk(SPEC, lq, r), (log_q, rows), card).release()


def test_kept_config_waypoints_and_optimization_waypoint_equal_eager(card):
    """``ee_rrt_star_config_waypoints`` (one replay of the kept one-row f64
    IK per waypoint) and ``optimization_waypoint`` (its ALM kept whole)
    against ``eager=True`` to the bit; a second optimization waypoint at
    the same obstacle count replays the first one's program."""
    from armour_tpu_torch.planner import hlp

    hlp.PROGRAMS.clear()
    obs = ObstacleSet.from_boxes([[0.45, 0.35, 0.55]], [[0.12, 0.12, 0.12]], 4)
    q_goal = np.array(Q_HOME) + np.array([0.5, 0.4, -0.3, 0.6, 0.2, -0.4, 0.3])
    got = hlp.ee_rrt_star_config_waypoints(SPEC, np.array(Q_HOME), q_goal, obs, seed=5, device=card)
    want = hlp.ee_rrt_star_config_waypoints(SPEC, np.array(Q_HOME), q_goal, obs, seed=5, device=card,
                                            eager=True)
    assert got is not None and np.array_equal(got, want)
    assert hlp.PROGRAMS.stats()["captures"] == 1
    rng = np.random.default_rng(9)
    obs = ObstacleSet.from_boxes([[-0.3, 0.1, 0.5]], [[0.15, 0.15, 0.15]], 8)
    for i in range(2):
        q_start = np.array(Q_HOME) + rng.uniform(-0.3, 0.3, 7)
        q_end = q_start + rng.uniform(-0.5, 0.5, 7)
        kept = hlp.optimization_waypoint(SPEC, q_start, q_end, obs, device=card)
        eager = hlp.optimization_waypoint(SPEC, q_start, q_end, obs, device=card, eager=True)
        assert kept[1] == eager[1] and np.array_equal(kept[0], eager[0]), i
    stats = hlp.PROGRAMS.stats()
    assert (stats["misses"], stats["captures"], stats["evictions"]) == (2, 2, 0), stats
    hlp.PROGRAMS.clear()


def test_battery_stage_cache_captures_nothing_after_warm_up(card):
    """20 iterations of the battery driver over 8 worlds of `assets/worlds`
    with workspace-path guidance (the ``ee`` and ``ik`` stages every
    iteration) and the mesh oracle: the runner's stage cache holds every
    stage, so a stage is captured once, at its first call, and never
    evicted; the ``ee`` and ``ik`` stages replay at every later iteration."""
    import glob
    import os

    from armour_tpu_torch.sim.scenarios import load_world_csv, stack_worlds

    cfg = dataclasses.replace(CFG, num_time_steps=32)
    root = os.path.join(os.path.dirname(__file__), "..", "assets", "worlds")
    files = sorted(glob.glob(os.path.join(root, "*.csv")))[:8]
    worlds = [load_world_csv(f, cfg.max_obstacles, torch.float32, device=card) for f in files]
    runner = harness.EpisodeRunner(SPEC, cfg, SimConfig(max_iterations=20), torch.float32, device=card)
    trace = []
    harness.run_batch_stepped(runner, *stack_worlds(worlds, torch.float32),
                              torch.Generator(device=card).manual_seed(0), collision_oracle="mesh",
                              hlp="ee_rrt_star", trace=trace)
    assert len(trace) >= 10, len(trace)
    assert runner.programs.capacity == len(harness.STAGES) + 4           # FK buckets 1, 2, 4, 8
    assert all(t["stage_evictions"] == 0 for t in trace), [t["stage_evictions"] for t in trace]
    # a key misses only where it was never met (nothing is evicted), and
    # each miss is one capture: a stage (the clearance, a new FK bucket) may
    # be met late, never captured again
    assert all(t["stage_captures"] == t["stage_misses"] for t in trace), trace
    assert sum(t["stage_captures"] for t in trace) <= runner.programs.capacity
    later = [t for t in trace[1:] if t["ee_worlds"]]
    assert later and all(t["stage_hits_by_name"].get("ik") == 1 for t in later)


def test_repeated_episodes_at_one_key_hold_no_memory(card):
    """Four episodes of five iterations at one (B, cap): the allocated
    memory at each iteration's start is level from the second iteration of
    an episode on, and every episode leaves what the first left."""
    runner, worlds = _episode(torch.float32, card, max_iterations=5)
    readings, after = [], []
    for e in range(4):
        gen = torch.Generator(device=card).manual_seed(e)
        inner = harness.generator_draws(runner.planner, runner.sim_cfg, 8, gen)
        seen = []

        def draws(i, inner=inner, seen=seen):
            seen.append(torch.cuda.memory_allocated())
            return inner(i)

        runner.run_batch(*worlds, gen, draws=draws)
        torch.cuda.synchronize()
        readings.append(seen)
        after.append(torch.cuda.memory_allocated())
    assert all(len(r) == 5 for r in readings), readings
    for r in readings:
        assert max(r[1:]) <= min(r[1:]) + (1 << 20), r
    assert max(after[1:]) <= after[0] + (1 << 20), after


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A (1, 1) mesh over an in-process NCCL group of one rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py")
    import socket

    from armour_tpu_torch.parallel.mesh import make_planner_mesh
    from armour_tpu_torch.parallel.multihost import init_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        yield make_planner_mesh(1)
    finally:
        torch.distributed.destroy_process_group()


def _step_inputs(seed, cap=8, n_obs=8):
    """A call of the sharded step: worlds of ``problem_set`` seed ``seed``,
    their first ``cap`` slots, and starts from numpy seed ``seed``."""
    p = problem_set(CFG, B, n_obs=n_obs, seed=seed, device="cuda")
    k_rand = torch.as_tensor(np.random.default_rng(seed).uniform(-0.6, 0.6, (B, 2, 7)),
                             dtype=torch.float32, device="cuda")
    return (p.q0, p.qd0, p.qdd0, p.q_des, p.zonos[:, :cap], p.masks[:, :cap]), k_rand


def test_kept_sharded_step_equals_eager_over_three_calls(card, one_rank_mesh):
    """Three calls at one (B, capacity) with other worlds and starts: each
    equals ``step(eager=True)`` to the bit in every field with the same
    launches; the first call captures the program's five graphs, the
    others replay them."""
    from armour_tpu_torch.parallel.mesh import sharded_plan_step
    from armour_tpu_torch.planner.armour import PlanProgram

    step = sharded_plan_step(SPEC, CFG, one_rank_mesh, torch.float32)
    progs = step.planner.batch_programs
    for i, seed in enumerate((0, 1, 2)):
        args, k_rand = _step_inputs(seed)
        out = {}
        for eager in (False, True):
            kernels.reset_launch_counts()
            out[eager] = (step(*args, k_rand=k_rand, eager=eager), kernels.launch_counts())
            torch.cuda.synchronize()
        (kept, c_kept), (ref, c_ref) = out[False], out[True]
        assert c_kept == c_ref == {MAIN: PASSES, "fused_collision_values_multi": 0,
                                   "fused_collision_value_jac": 0}, i
        for f in ("k", "feasible", "cost", "max_violation", "torque_radius"):
            assert _same(getattr(kept, f), getattr(ref, f)), (i, f)
        stats = progs.stats()
        assert stats["captures"] == len(PlanProgram.STEPS) and stats["misses"] == 1, (i, stats)
        assert stats["hits"] == i and stats["entries"] == 1, (i, stats)
    assert list(progs.entries) == [(B, 8)]


def test_kept_sharded_step_holds_no_memory(card, one_rank_mesh):
    """Ten replays of the kept step allocate nothing that stays."""
    from armour_tpu_torch.parallel.mesh import sharded_plan_step

    step = sharded_plan_step(SPEC, CFG, one_rank_mesh, torch.float32)
    calls = [_step_inputs(seed) for seed in (3, 4)]
    for args, k_rand in calls:
        step(*args, k_rand=k_rand)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for i in range(10):
        args, k_rand = calls[i % 2]
        step(*args, k_rand=k_rand)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base + (1 << 20), (base, torch.cuda.memory_allocated())
    assert step.planner.batch_programs.stats()["captures"] == 5


def test_sharded_step_keeps_three_shard_capacities_without_eviction(card, one_rank_mesh):
    """The shard capacities that ``chip_smoke.py`` plans through one step
    (8 slots, a cp = 2 rank's 4 of 8 and 20 of 40) are three programs of
    one cache: a second round replays each, with no eviction."""
    from armour_tpu_torch.parallel.mesh import sharded_plan_step

    step = sharded_plan_step(SPEC, CFG, one_rank_mesh, torch.float32)
    progs = step.planner.batch_programs
    calls = [_step_inputs(5, 8), _step_inputs(5, 4), _step_inputs(7, 20, n_obs=40)]
    first = [step(*args, k_rand=k_rand) for args, k_rand in calls]
    again = [step(*args, k_rand=k_rand) for args, k_rand in calls]
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert _same(a.k, b.k) and torch.equal(a.feasible, b.feasible)
    stats = progs.stats()
    assert stats["evictions"] == 0 and stats["misses"] == 3 and stats["hits"] == 3, stats
    assert sorted(progs.entries) == [(B, 4), (B, 8), (B, 20)]
    assert stats["captures"] == 15, stats


def test_captured_step_replays_and_counts_what_runs(card):
    x = torch.zeros(4, device=card)
    step = CapturedStep(lambda: x.add_(1.0))
    for _ in range(5):                     # a real first step, a capture, 4 replays
        step()
    assert step.graph is not None and float(x.sum()) == 20.0
    # a step that synchronises with the host cannot be captured: it raises
    bad = CapturedStep(lambda: float(x.sum()))
    with pytest.raises(RuntimeError):
        bad()


def test_a_failed_capture_leaves_the_process_able_to_release_and_capture(card):
    """A capture invalidated by a host read raises; releasing it and an
    earlier captured step, emptying the cache and capturing anew then work
    (the caching allocator was left routing the side stream to the failed
    capture's pool, and the next pool released aborted the process)."""
    x = torch.zeros(4, device=card)
    good = CapturedStep(lambda: x.add_(1.0))
    good()
    good()
    bad = CapturedStep(lambda: float(x.sum()))
    with pytest.raises(RuntimeError):
        bad()
    bad.release()
    good.release()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    again = CapturedStep(lambda: x.mul_(2.0))
    again()
    again()
    assert float(x.sum()) == 32.0 and again.graph is not None
    again.release()


def test_cached_plan_whose_capture_syncs_raises_and_is_not_kept(card):
    """A build that reads a device value on the host cannot be captured:
    ``plan`` raises (no fallback to the eager path) and keeps no program."""
    pl = _planner("default", card)
    build = pl.build_fixed

    def syncing(*args):
        prob = build(*args)
        float(prob.q0.sum())
        return prob

    pl.build_fixed = syncing
    with pytest.raises(RuntimeError):
        pl.plan(*_plan_worlds("default", card)[0])
    assert not pl.programs.entries


def test_batched_plan_whose_capture_syncs_raises_and_is_not_kept(card):
    """A culling stage that reads a device value on the host cannot be
    captured: ``plan_batch`` raises and keeps no program."""
    pl = _planner("default", card)
    cull = pl.cull_keep

    def syncing(*args):
        keep = cull(*args)
        float(keep.sum())
        return keep

    pl.cull_keep = syncing
    with pytest.raises(RuntimeError):
        pl.plan_batch(*_worlds("default", 40, 7))
    assert not pl.batch_programs.entries


def test_episode_whose_capture_syncs_raises_and_is_not_kept(card, monkeypatch):
    """A post-plan step that reads a device value on the host cannot be
    captured: ``run_batch`` raises (no fallback to the op-by-op loop) and
    keeps no episode program."""
    runner, worlds = _episode(torch.float32, card)
    checks = harness._violations

    def syncing(*args):
        out = checks(*args)
        float(out[0].sum())
        return out

    monkeypatch.setattr(harness, "_violations", syncing)
    with pytest.raises(RuntimeError):
        runner.run_batch(*worlds)
    assert not runner.programs.entries
