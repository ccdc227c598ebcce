"""The batched plans through their programs kept per (B, bucket)
(``ArmourPlanner.run_program``: ``plan_batch``, ``EpisodeRunner.run_batch``
and the battery driver), on the CPU, where every program runs op by op
through the same buffers, keys and resets as on the card; only the capture
is card-only (`tests/test_torch_graphs_cuda.py` holds the replays).

Every kept plan is held to a fresh planner's ``plan_batch(eager=True)``
(``build_probs`` and ``solve`` op by op, no program) on the same inputs and
starts, to the bit; the episode drivers to their runs with the program
replaced by the op-by-op build and solve.  A second call of each kept step
also runs under a dispatch mode that fails on what a CUDA graph capture
cannot hold (the keep mask's host trip stays outside the steps).  A short
ALM (2 x 4 Gauss-Newton iterations) and T=16; no JAX here.
"""

import dataclasses
import gc
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import GraspConfig, PlannerConfig, SimConfig
from armour_tpu_torch.planner.armour import ArmourPlanner, PlanProgram, ReachStage
from armour_tpu_torch.problems import problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import harness

SPEC = kinova_gen3_spec()
CFG = PlannerConfig(num_time_steps=16, nlp_outer_iters=2, nlp_inner_iters=4)
F64 = torch.float64
B = 3
Q_SI = (0.0, 0.5, 0.0, -0.5, 0.0, 0.5, 0.0)
MODES = ("default", "orig", "smooth", "grasp", "bernstein+si", "12starts")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A few worlds at a time: one intra-op thread runs them as fast as
    eight, and leaves the cores to the other test workers (restored after
    the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planner(mode):
    kw = {"orig": dict(traj_type="orig"),
          "grasp": dict(grasp=GraspConfig(object_mass=0.2, u_s=0.6, surf_rad=0.03)),
          "bernstein+si": dict(self_intersection=True)}.get(mode, {})
    cfg = {"12starts": dataclasses.replace(CFG, nlp_num_starts=12),
           "smooth": dataclasses.replace(CFG, smooth_collision_tau=1e-3)}.get(mode, CFG)
    return ArmourPlanner(SPEC, cfg, F64, device="cpu", **kw)


def _world_sets(mode):
    """Two world sets of the mode: 8 live obstacles (bucket 8, one program
    builds and solves) and 40 (culled: the reach stage, the host trip, the
    program of the culled bucket)."""
    if mode == "grasp":
        q0 = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0]) + \
            np.random.default_rng(0).uniform(-0.05, 0.05, (B, 7))
        p8 = problem_set(CFG, B, n_obs=8, seed=0, device="cpu")
        p40 = problem_set(CFG, B, n_obs=40, seed=7, device="cpu")
        z = np.zeros((B, 7))
        return [(q0, z, z, q0 + 0.3 * CFG.k_range, p.zonos, p.masks) for p in (p8, p40)]
    q_center = Q_SI if mode == "bernstein+si" else (0.6543, -0.0876, -0.4837, -1.2278, -1.5735,
                                                     -1.0720, 0.0)
    sets = [tuple(problem_set(CFG, B, n_obs=n, seed=s, device="cpu", q_center=q_center))
            for n, s in ((8, 0), (40, 7))]
    if mode == "bernstein+si":
        sets = [(a[0], np.zeros_like(a[0]), np.zeros_like(a[0]), *a[3:]) for a in sets]
    return sets


def _starts(pl, seed):
    return pl.random_starts(B, torch.Generator().manual_seed(seed))


def _bits(x):
    x = x.contiguous()
    return x.view(torch.int64) if x.dtype == F64 else x


def _assert_same(a, b):
    for name in a._fields:
        assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name


def _eager(mode, args, k_rand):
    return _planner(mode).plan_batch(*args, k_rand=k_rand, eager=True)


@pytest.mark.parametrize("mode", MODES)
def test_kept_plan_batch_equals_eager_plan_batch(mode):
    pl = _planner(mode)
    for i, args in enumerate(_world_sets(mode)):
        k_rand = _starts(pl, i)
        for _ in range(2):                    # the first call and a replay
            _assert_same(pl.plan_batch(*args, k_rand=k_rand), _eager(mode, args, k_rand))
    keys = list(pl.batch_programs.entries)
    assert keys[0] == (B, 8) and keys[1] == (B, CFG.max_obstacles, "reach"), keys
    assert len(keys) == 3 and keys[2][:2] == (B, CFG.max_obstacles)
    assert pl.batch_programs.stats()["hits"] == 3    # bucket 8's, the culled stage's and program's
    assert pl.batch_programs.stats()["captures"] == 0   # nothing is captured on the CPU


def _culled_worlds():
    """(worlds of culled bucket 8, the same worlds with culled bucket 16):
    in the second, four slots that culling dropped hold copies of a kept
    obstacle in every world, and each world keeps more than 8."""
    args = tuple(problem_set(CFG, B, n_obs=40, seed=7, device="cpu"))
    pl = _planner("default")
    _, _, aabb_c, aabb_r = pl.reachable_sets(*args[:3])
    zonos = torch.as_tensor(args[4])
    keep = pl.cull_keep(aabb_c, aabb_r, zonos, torch.as_tensor(args[5])).numpy()
    assert keep.sum(1).max() <= 8
    z16 = np.array(args[4], copy=True)
    for w in range(B):
        kept, dropped = np.nonzero(keep[w])[0], np.nonzero(~keep[w] & args[5][w])[0]
        z16[w, dropped[: 12 - len(kept)]] = z16[w, kept[0]]
    return args, (*args[:4], z16, args[5])


def test_bucket_sequence_and_two_world_sets_at_one_key():
    """Culled buckets 16 -> 8 -> 16 -> 8, the second visit of each bucket
    on other worlds (starts, goals and starting states moved): the
    program's solver state, outer state and bank are reset by every call."""
    w8, w16 = _culled_worlds()
    rng = np.random.default_rng(1)

    def moved(args):
        dq = rng.uniform(-0.02, 0.02, (B, 7))
        return (args[0] + dq, args[1], args[2], args[3] - dq, *args[4:])

    pl = _planner("default")
    seq = [(w16, 16), (w8, 8), (moved(w16), 16), (moved(w8), 8)]
    for i, (args, bucket) in enumerate(seq):
        k_rand = _starts(pl, 10 + i)
        got = pl.plan_batch(*args, k_rand=k_rand, k_warm=np.full((B, 7), 0.1 * i))
        ref = _planner("default").plan_batch(*args, k_rand=k_rand, k_warm=np.full((B, 7), 0.1 * i),
                                             eager=True)
        _assert_same(got, ref)
        assert pl.batch_programs.entries.get((B, CFG.max_obstacles, bucket)) is not None, i
    stats = pl.batch_programs.stats()
    assert (stats["misses"], stats["hits"], stats["evictions"]) == (3, 5, 0)


class _NoHostTraffic(TorchDispatchMode):
    """Fails on a tensor made from host data and on a host read of a tensor
    value: what a CUDA graph capture cannot record."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default):
            raise AssertionError(f"{func} inside a kept step")
        return func(*args, **(kwargs or {}))


_IN_STEP = [False]


def _guarded(step):
    """``step`` run under ``_NoHostTraffic``, with ``Tensor.numpy``,
    ``tolist`` and ``cpu`` failing while it runs."""
    def run():
        _IN_STEP[0] = True
        try:
            with _NoHostTraffic():
                step()
        finally:
            _IN_STEP[0] = False
    return run


@pytest.mark.parametrize("culled", [False, True], ids=["bucket8", "culled"])
def test_second_call_of_each_kept_step_makes_no_host_traffic(culled, monkeypatch):
    """The input copies and the keep mask's host trip aside, every step of
    a kept program (the reach stage's, the build's, the solve's three and
    the verification's) replays with no tensor made from host data and no
    host read of a device value."""
    args = _world_sets("default")[int(culled)]
    pl = _planner("default")
    pl.plan_batch(*args, k_rand=_starts(pl, 0))
    progs = list(pl.batch_programs.entries.values())
    assert [type(p) for p in progs] == ([ReachStage, PlanProgram] if culled else [PlanProgram])
    for prog in progs:
        if isinstance(prog, ReachStage):
            prog.step = _guarded(prog.step)
            continue
        prog.build = _guarded(prog.build)
        prog.keep["steps"] = tuple(_guarded(s) for s in prog.keep["steps"])
        prog.keep["verify"] = _guarded(prog.keep["verify"])
    for name in ("numpy", "tolist", "cpu"):
        real = getattr(torch.Tensor, name)

        def no_host(self, *a, _real=real, _n=name, **k):
            if _IN_STEP[0]:
                pytest.fail(f"Tensor.{_n} inside a kept step")
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, no_host)
    k_rand = _starts(pl, 1)
    args = (args[0], args[1], args[2], np.asarray(args[3]) + 0.01, *args[4:])
    got = pl.plan_batch(*args, k_rand=k_rand)
    monkeypatch.undo()
    _assert_same(got, _eager("default", args, k_rand))
    assert pl.batch_programs.stats()["hits"] == len(progs)


def test_batch_cache_evicts_a_stage_with_its_programs_and_releases():
    w8, w16 = _culled_worlds()
    pl = _planner("default")
    assert pl.batch_programs.capacity == CFG.max_obstacles // 8 + 1
    pl.batch_programs.capacity = 2
    pl.plan_batch(*w8)
    reach, p8 = pl.batch_programs.entries.values()
    pl.plan_batch(*w16)                  # the stage stays, bucket 8 goes
    assert p8.steps == [] and p8.inputs == () and p8.prob is None
    p16 = pl.batch_programs.entries[(B, CFG.max_obstacles, 16)]
    assert p16.parent is reach
    # another batch width: its stage evicts the first, which takes its program along
    two = [x[:2] for x in w8]
    pl.plan_batch(*two)
    assert reach.steps == [] and reach.out is None and p16.steps == []
    assert list(pl.batch_programs.entries)[0] == (2, CFG.max_obstacles, "reach")
    _assert_same(pl.plan_batch(*w16), _eager("default", w16, pl.random_starts(B)))
    stats = pl.batch_programs.stats()
    assert stats["evictions"] >= 5 and stats["entries"] <= 2
    pl.batch_programs.clear()
    assert not pl.batch_programs.entries


def test_a_dropped_planner_releases_its_programs():
    """The programs hold their planner weakly: dropping the planner frees
    its caches, which release every program's steps and buffers with no
    garbage collection."""
    w8, _ = _culled_worlds()
    pl = _planner("default")
    pl.plan_batch(*w8)
    pl.plan(w8[0][0], w8[1][0], w8[2][0], w8[3][0], ObstacleSet(w8[4][0], w8[5][0]))
    progs = [*pl.batch_programs.entries.values(), *pl.programs.entries.values()]
    assert len(progs) == 3 and all(p.steps for p in progs)
    gc.disable()
    try:
        del pl
        assert all(p.steps == [] for p in progs)
    finally:
        gc.enable()


def _op_by_op_run_program(self, q0, qd0, qdd0, q_des, zonos, masks, k_rand=None, k_warm=None,
                          generator=None, full_width=False, marks=None, eager=True):
    """``run_program`` with no program: the eager build and solve, whatever
    ``eager`` says."""
    if full_width:
        prob = self.build_fixed(self._t(q0), self._t(qd0), self._t(qdd0), self._t(zonos),
                                self._t(masks, torch.bool))
    else:
        prob = self.build_probs(q0, qd0, qdd0, zonos, masks)
    if marks is not None:
        marks["built"] = time.perf_counter()
    return self.solve(prob, q_des, k_rand=k_rand, k_warm=k_warm, generator=generator,
                      eager=True), prob


def _episode_worlds():
    w8, _ = _culled_worlds()
    goals = np.asarray(w8[0]) + 0.4
    return np.asarray(w8[0]), goals, w8[4], w8[5]


@pytest.mark.parametrize("driver", ["run_batch", "run_batch_stepped"])
def test_episode_drivers_equal_their_op_by_op_runs(driver, monkeypatch):
    """Two iterations of the episode program (its plan kept at (B, cap))
    and one of the battery driver (culled, kept per bucket) against the same
    runs with the plan op by op: every plan and the summary to the bit.
    Each driver releases its programs when it returns."""
    starts, goals, zonos, masks = _episode_worlds()
    sim = SimConfig(plant_dt=0.05, max_iterations=2 if driver == "run_batch" else 1)
    kept_run = ArmourPlanner.run_program
    out, plans, made = {}, {}, []
    for kept in (True, False):
        runner = harness.EpisodeRunner(SPEC, CFG, sim, device="cpu")
        plans[kept] = []

        def recorded(self, *args, _impl=kept_run if kept else _op_by_op_run_program, _log=plans[kept],
                     **kw):
            res, prob = _impl(self, *args, **kw)
            _log.append(res)
            return res, prob

        monkeypatch.setattr(ArmourPlanner, "run_program", recorded)
        if kept:
            runner.planner.batch_programs.run = _spy(runner.planner.batch_programs.run, made)
        gen = torch.Generator().manual_seed(3)
        trace = []
        if driver == "run_batch":
            out[kept] = runner.run_batch(starts, goals, zonos, masks, gen)
        else:
            out[kept] = harness.run_batch_stepped(runner, starts, goals, zonos, masks, gen,
                                                  collision_oracle="box", trace=trace)
        monkeypatch.undo()
        if kept:
            cache = runner.planner.batch_programs
            assert not cache.entries and cache.stats()["misses"] >= 1
            assert made and all(p.steps == [] for p in made)
            if driver == "run_batch":
                assert list(dict.fromkeys(made)) == made[:1]       # one program, (B, cap)
                assert cache.stats()["hits"] == 1
            else:
                (tr,) = trace
                assert (tr["program_captures"], tr["program_hits"], tr["program_misses"]) == (0, 0, 2)
                assert tr["memory_allocated"] is None
                assert tr["bucket"] == CFG.max_obstacles and tr["bucket_culled"] == 8
                assert 0 < tr["build_probs_s"] and 0 < tr["solve_s"]
    assert len(plans[True]) == len(plans[False]) == sim.max_iterations
    for a, b in zip(plans[True], plans[False]):
        _assert_same(a, b)
    for name in out[True]._fields:
        a, b = getattr(out[True], name), getattr(out[False], name)
        assert (a is None and b is None) or torch.equal(_bits(a), _bits(b)), name


def _spy(run, made):
    """``ProgramCache.run`` that records each program it calls."""
    def spied(key, make, *args, **kw):
        out = run(key, make, *args, **kw)
        made.append(run.__self__.entries[key])
        return out
    return spied
