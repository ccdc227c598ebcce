"""``ArmourPlanner.plan`` through its program kept per obstacle bucket (the
counterpart of the JAX package's ``jax.jit`` of its plan function), on the
CPU, where the program runs op by op: its static-input copies, its cache
keys and its eviction are the same code as on the card, only the capture is
card-only (`tests/test_torch_graphs_cuda.py` holds the replays).

Every cached plan is held to a fresh planner's eager ``plan`` (build and
solve op by op, no program) on the same inputs and starts, to the bit.  The
second call of a program is also run under a dispatch mode that fails on
what a CUDA graph capture cannot hold: a tensor made from host data (a
copy to the card) and a read of a device value on the host.  No JAX here.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.planner import armour, nlp
from armour_tpu_torch.planner.armour import ArmourPlanner, PlanProgram
from armour_tpu_torch.problems import problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import agent
from armour_tpu_torch.utils.graphs import CapturedStep

SPEC = kinova_gen3_spec()
# a short ALM (2 x 4 Gauss-Newton iterations): the program and the eager
# path run the same iterations, whatever their number
CFG = PlannerConfig(num_time_steps=16, nlp_outer_iters=2, nlp_inner_iters=4)
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A world at a time: one intra-op thread runs it as fast as eight, and
    leaves the cores to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    """Three worlds of bucket 8 and one of bucket 16 (12 live slots), each
    with its own random starts."""
    p8 = problem_set(CFG, 3, n_obs=8, seed=0, device="cpu")
    p40 = problem_set(CFG, 1, n_obs=40, seed=7, device="cpu")
    m16 = p40.masks[0].copy()
    m16[12:] = False
    out = [(p8.q0[i], p8.qd0[i], p8.qdd0[i], p8.q_des[i], ObstacleSet(p8.zonos[i], p8.masks[i]))
           for i in range(3)]
    out.append((p40.q0[0], p40.qd0[0], p40.qdd0[0], p40.q_des[0], ObstacleSet(p40.zonos[0], m16)))
    rng = np.random.default_rng(3)
    return [(w, rng.uniform(-0.6, 0.6, (CFG.nlp_num_starts - 2, 7))) for w in out]


def _bits(x):
    x = x.contiguous()
    return x.view(torch.int64) if x.dtype == F64 else x


def _assert_same(a, b):
    for name in a._fields:
        assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name


def _eager(world, k_rand):
    return ArmourPlanner(SPEC, CFG, F64, device="cpu").plan(*world, k_rand=k_rand, eager=True)


def test_cached_plan_equals_eager_plan_across_worlds_and_buckets(worlds):
    pl = ArmourPlanner(SPEC, CFG, F64, device="cpu")
    for world, k_rand in worlds:         # buckets 8, 8, 8, then 16
        _assert_same(pl.plan(*world, k_rand=k_rand), _eager(world, k_rand))
    stats = pl.programs.stats()
    assert (stats["misses"], stats["hits"], stats["evictions"], stats["entries"]) == (2, 2, 0, 2)
    assert stats["captures"] == 0        # nothing is captured on the CPU
    assert sorted(pl.programs.entries) == [(1, 8), (1, 16)]


def test_cache_evicts_past_its_bound_and_releases(worlds):
    pl = ArmourPlanner(SPEC, CFG, F64, device="cpu")
    pl.programs.capacity = 1
    (w8, k8), (w16, k16) = worlds[0], worlds[3]
    pl.plan(*w8, k_rand=k8)
    first = next(iter(pl.programs.entries.values()))
    pl.plan(*w16, k_rand=k16)            # evicts bucket 8
    assert first.steps == [] and first.inputs == () and first.prob is None
    _assert_same(pl.plan(*w8, k_rand=k8), _eager(w8, k8))   # made again
    stats = pl.programs.stats()
    assert (stats["misses"], stats["hits"], stats["evictions"], stats["entries"]) == (3, 0, 2, 1)
    pl.programs.clear()
    assert not pl.programs.entries


class _NoHostTraffic(TorchDispatchMode):
    """Fails on a tensor made from host data and on a host read of a tensor
    value: what a CUDA graph capture cannot record."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default):
            raise AssertionError(f"{func} inside the program")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("traj_type", ["bernstein", "orig"])
def test_program_replay_makes_no_host_traffic(worlds, traj_type, monkeypatch):
    pl = ArmourPlanner(SPEC, CFG, F64, device="cpu", traj_type=traj_type)
    (w0, k0), (w1, k1) = worlds[:2]
    b, args0 = pl.plan_args(*w0, k_rand=k0)
    prog = PlanProgram(pl, b)
    prog(*args0)                         # the first call makes the constants
    _, args1 = pl.plan_args(*w1, k_rand=k1)
    for name in ("numpy", "tolist", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, _n=name, **k: pytest.fail(f"Tensor.{_n}"))
    with _NoHostTraffic():
        res = prog(*args1)
    monkeypatch.undo()
    eager = ArmourPlanner(SPEC, CFG, F64, device="cpu", traj_type=traj_type).plan(
        *w1, k_rand=k1, eager=True)
    _assert_same(type(res)(*(x[0] for x in res)), eager)


class _FakeCapture(CapturedStep):
    """A CapturedStep that runs its step op by op (no card here)."""

    made = []

    def __init__(self, step):
        super().__init__(step)
        _FakeCapture.made.append(self)

    def __call__(self):
        self.step()


def test_loops_release_their_capture(worlds, monkeypatch):
    """The solver's iteration and the rollout's RK4 step are released when
    their loop ends (on the card a step left to the garbage collector held
    its loop's state and the bank, about 1 GB per battery iteration, until
    a full collection); a solve through ``keep`` keeps its step."""
    fake = lambda step, dev, eager: _FakeCapture(step)   # noqa: E731
    monkeypatch.setattr(nlp, "stepper", fake)
    monkeypatch.setattr(agent, "stepper", fake)
    _FakeCapture.made = []
    pl = ArmourPlanner(SPEC, CFG, F64, device="cpu")
    p = problem_set(CFG, 2, n_obs=8, seed=0, device="cpu")
    prob = pl.build_probs(p.q0, p.qd0, p.qdd0, p.zonos, p.masks)
    pl.solve(prob, p.q_des)
    sim = SimConfig(t_move=3 * SimConfig().plant_dt)
    traj = agent.TrajParams(p.q0, p.qd0, p.qdd0, np.zeros((2, 7)), np.zeros(2))
    agent.rollout(SPEC, sim, p.q0, p.qd0, traj, agent.TrueParams(np.ones((2, 7)), np.ones((2, 7))),
                  CFG.duration, device="cpu", dtype=F64)
    assert len(_FakeCapture.made) == 2 and all(s.step is None for s in _FakeCapture.made)
    keep = {}
    monkeypatch.setattr(armour, "stepper", fake)   # the build and verification graphs of a program
    pl.solve(prob, p.q_des, keep=keep)
    assert all(s.step is not None for s in (*keep["steps"], keep["verify"]))
    b, args = pl.plan_args(*worlds[0][0], k_rand=worlds[0][1])
    prog = PlanProgram(pl, b)
    prog(*args)
    # the build, the first bank pass, the iteration, the outer update, the verification
    assert [s.step is not None for s in prog.steps] == [True] * 5
    prog.release()
    assert all(s.step is None for s in _FakeCapture.made[-5:])
