"""The guidance's kept programs on the CPU, against the JAX package and
against their op-by-op runs:

- the IK (``planner/hlp.py::ik_to_position``) as a kept program, against
  ``jax.jit(jax.vmap(ik_to_position))``: q within 1e-9 where the target is
  reachable, ``ok`` equal; its second call makes no host traffic (what a
  CUDA graph capture cannot record);
- the IK at B rows, as the battery driver pads it, equal to the bit on the
  real rows to the IK of those rows alone (NaN rows among the padding);
- ``ee_rrt_star_config_waypoints(device="cpu")`` within 1e-9 of the JAX
  path, each waypoint a replay of one kept program, equal to ``eager=True``
  to the bit;
- the mesh refinement's FK padded to its row bucket equal to the bit to
  the FK of the flagged windows alone, and the buckets;
- ``optimization_waypoint(device="cpu")`` within 1e-6 of JAX with ``ok``
  equal, kept against ``eager=True`` to the bit, one program per obstacle
  count;
- the battery driver with workspace-path guidance (``hlp="ee_rrt_star"``):
  the ``ee`` and ``ik`` stages kept against ``eager=True`` to the bit,
  replayed with no host traffic, and its stage cache sized to hold them all.

On the CPU every kept program runs op by op through the same buffers as on
the card; the captures and replays are held on the card by
`tests/test_torch_graphs_cuda.py`.  Small sizes: B <= 8, T = 16; no JAX
planner or rollout is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.planner import hlp as jax_hlp
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import SimConfig
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.dynamics.utility import ee_pose
from armour_tpu_torch.planner import hlp
from armour_tpu_torch.sim import harness
from armour_tpu_torch.utils.graphs import KeptFunction, ProgramCache
from test_torch_batch_program import _bits, _guarded, _IN_STEP, one_torch_thread  # noqa: F401
from test_torch_episode_program import (SPEC, _assert_same_summary, _fail_host_reads,
                                        _guard_after_first_call, _runner, three_worlds)

JSPEC = jax_kinova_gen3_spec()
Q_HOME = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
MID = (np.array([[0.45, 0.35, 0.55]]), np.array([[0.12, 0.12, 0.12]]))   # on the straight route


@pytest.fixture(autouse=True)
def fresh_programs(monkeypatch):
    """Each test keeps its programs in a cache of its own, released after."""
    monkeypatch.setattr(hlp, "PROGRAMS", ProgramCache(hlp.PROGRAMS.capacity))
    yield
    hlp.PROGRAMS.clear()


def _both(centers, sides, cap=4):
    return (ObstacleSet.from_boxes(centers, sides, cap),
            JaxObstacleSet.from_boxes(centers, sides, cap))


def _ik_inputs(rng, B, reach=True):
    """Targets (B, 3) at the end effector of poses near Q_HOME (the last one
    out of reach unless ``reach``) and seeds (B, 7) near Q_HOME."""
    q_true = Q_HOME + rng.uniform(-0.4, 0.4, (B, 7))
    targets = ee_pose(SPEC, torch.as_tensor(q_true))[1].numpy()
    if not reach:
        targets[-1] = [3.0, 0.0, 0.5]
    return targets, Q_HOME + rng.uniform(-0.2, 0.2, (B, 7))


def test_kept_ik_matches_jax_and_replays_with_no_host_traffic(rng, monkeypatch):
    targets, seeds = _ik_inputs(rng, 6, reach=False)
    q_j, ok_j = jax.jit(jax.vmap(lambda t, s: jax_hlp.ik_to_position(JSPEC, t, s)))(
        jnp.asarray(targets), jnp.asarray(seeds))

    def ik(t, s):
        return hlp.ik_to_position(SPEC, t, s)

    args = (torch.as_tensor(targets), torch.as_tensor(seeds))
    q_t, ok_t = (x.clone() for x in hlp.kept(("ik",), ik, *args))
    # out of reach, the iteration saturates on the joint box and amplifies
    # rounding: q is compared where the target is reachable, ok everywhere
    np.testing.assert_allclose(q_t[:5].numpy(), np.asarray(q_j)[:5], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t[:5].all() and not ok_t[5]
    # the second call replays the kept step (on a card, the graph) with no
    # tensor made from host data and no host read, to the same bits
    ran = {}
    _fail_host_reads(monkeypatch)
    _guard_after_first_call(monkeypatch, KeptFunction, ("step",), ran)
    prog = next(iter(hlp.PROGRAMS.entries.values()))
    prog(*args)                                   # the guard goes on after this call
    q_2, ok_2 = hlp.kept(("ik",), ik, *args)
    assert list(ran.values()) == [1]
    assert torch.equal(_bits(q_2), _bits(q_t)) and torch.equal(ok_2, ok_t)
    assert hlp.PROGRAMS.stats()["misses"] == 1 and hlp.PROGRAMS.stats()["hits"] == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_padded_ik_equals_the_real_rows_alone_to_the_bit(rng, dtype):
    """The battery driver runs the IK at all B rows: a row without a path
    asks for its own end-effector position from its own q.  Padding rows,
    NaN ones too, change no real row's bits."""
    targets, seeds = _ik_inputs(rng, 3)
    alone = hlp.ik_to_position(SPEC, torch.as_tensor(targets, dtype=dtype),
                               torch.as_tensor(seeds, dtype=dtype))
    q_pad = Q_HOME + rng.uniform(-1.0, 1.0, (5, 7))
    own = ee_pose(SPEC, torch.as_tensor(q_pad))[1].numpy()
    own[3] = np.nan                               # a done world's state may be non-finite
    real = [6, 1, 3]                              # the real rows among the padding
    pad_t = np.zeros((8, 3))
    pad_s = np.zeros((8, 7))
    pad_t[real], pad_s[real] = targets, seeds
    rest = [i for i in range(8) if i not in real]
    pad_t[rest], pad_s[rest] = own, q_pad
    padded = hlp.ik_to_position(SPEC, torch.as_tensor(pad_t, dtype=dtype),
                                torch.as_tensor(pad_s, dtype=dtype))
    assert torch.equal(_bits(padded[0][real]), _bits(alone[0]))
    assert torch.equal(padded[1][real], alone[1]) and alone[1].all()
    assert bool(padded[1][rest[:3]].all())        # a padding row stays where it is


def test_config_waypoints_match_jax_one_kept_program_for_every_waypoint():
    obs, jobs = _both(*MID)
    q_goal = Q_HOME + np.array([0.5, 0.4, -0.3, 0.6, 0.2, -0.4, 0.3])
    want = jax_hlp.ee_rrt_star_config_waypoints(JSPEC, Q_HOME, q_goal, jobs, seed=5)
    got = hlp.ee_rrt_star_config_waypoints(SPEC, Q_HOME, q_goal, obs, seed=5, device="cpu")
    assert want is not None and got is not None and len(got) >= 4
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[-1], q_goal, atol=1e-12)
    # one row, float64: one program, replayed for every later waypoint
    stats = hlp.PROGRAMS.stats()
    assert (stats["misses"], stats["hits"], stats["entries"]) == (1, len(got) - 2, 1)
    (key,) = hlp.PROGRAMS.entries
    assert key[-2:] == (((1, 3), torch.float64), ((1, 7), torch.float64))
    eager = hlp.ee_rrt_star_config_waypoints(SPEC, Q_HOME, q_goal, obs, seed=5, device="cpu",
                                             eager=True)
    assert np.array_equal(eager, got)
    assert hlp.PROGRAMS.stats()["hits"] == len(got) - 2


def test_padded_fk_bucket_equals_the_flagged_windows_alone_to_the_bit(rng):
    B, n_chk = 8, 5
    log_q = torch.as_tensor(Q_HOME + rng.uniform(-1.0, 1.0, (B, n_chk, 7)))
    assert [harness.fk_rows(F, B) for F in range(1, B + 1)] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert [harness.fk_rows(F, 100) for F in (1, 3, 33, 64, 65, 100)] == [1, 4, 64, 64, 100, 100]
    flagged = np.array([5, 2, 7])
    rows = np.resize(flagged, harness.fk_rows(len(flagged), B))      # as the driver pads them
    assert rows.tolist() == [5, 2, 7, 5]
    for dtype in (torch.float64, torch.float32):
        lq = log_q.to(dtype)
        Rw, pw = harness.windows_fk(SPEC, lq, torch.as_tensor(rows))
        Rw1, pw1 = harness.windows_fk(SPEC, lq, torch.as_tensor(flagged))
        n = len(flagged) * n_chk
        assert Rw.shape[0] == len(rows) * n_chk and Rw1.shape[0] == n
        assert torch.equal(_bits(Rw[:n]), _bits(Rw1)) and torch.equal(_bits(pw[:n]), _bits(pw1))
        # window by window, as the oracle reads them
        R_ref, p_ref = forward_kinematics(SPEC, lq[torch.as_tensor(flagged)].reshape(-1, 7))
        assert torch.equal(_bits(Rw1), _bits(R_ref)) and torch.equal(_bits(pw1), _bits(p_ref))


def test_optimization_waypoint_kept_matches_jax_and_eager():
    rng = np.random.default_rng(3)
    obs, jobs = _both(np.array([[-0.3, 0.1, 0.5]]), np.array([[0.15, 0.15, 0.15]]))
    q_start = Q_HOME + rng.uniform(-0.3, 0.3, 7)
    q_goal = q_start + rng.uniform(-0.5, 0.5, 7)
    kw = dict(buffer_dist=0.08, outer_iters=4, inner_iters=6)
    want, ok_j = jax_hlp.optimization_waypoint(JSPEC, q_start, q_goal, jobs, **kw)
    got, ok_t = hlp.optimization_waypoint(SPEC, q_start, q_goal, obs, device="cpu", **kw)
    assert ok_t == ok_j
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    eager, ok_e = hlp.optimization_waypoint(SPEC, q_start, q_goal, obs, device="cpu", eager=True, **kw)
    assert ok_e == ok_t and np.array_equal(eager, got)
    # another start at the same obstacle count replays the same program;
    # another count is a program of its own
    hlp.optimization_waypoint(SPEC, q_goal, q_start, obs, device="cpu", **kw)
    wide = ObstacleSet.from_boxes(np.array([[-0.3, 0.1, 0.5]]), np.array([[0.15, 0.15, 0.15]]), 8)
    hlp.optimization_waypoint(SPEC, q_start, q_goal, wide, device="cpu", **kw)
    stats = hlp.PROGRAMS.stats()
    assert (stats["misses"], stats["hits"], stats["entries"]) == (2, 1, 2)


def test_battery_with_workspace_paths_keeps_ee_and_ik_stages(monkeypatch):
    """Two iterations of ``run_batch_stepped(hlp="ee_rrt_star")`` over two
    worlds with workspace paths (world 2 reaches its goal at once, so one
    path is followed in the second iteration) and a world without one: kept
    against ``eager=True``, every summary field to the bit; every stage's
    second call makes no host traffic; the stage cache holds every stage
    (nothing evicted) and the IK runs at all three rows."""
    starts, goals, zonos, masks = three_worlds()
    sim = SimConfig(plant_dt=0.05, max_iterations=2)
    real_plan_ee = harness.ee_rrt_star_waypoints
    monkeypatch.setattr(harness, "ee_rrt_star_waypoints",      # world 1 gets no workspace path
                        lambda spec, q, g, obs, seed=0, **k: None if seed == 1
                        else real_plan_ee(spec, q, g, obs, seed=seed, **k))
    rows = []
    real_ik = harness.ik_to_position
    monkeypatch.setattr(harness, "ik_to_position",
                        lambda spec, t, s: rows.append(t.shape[0]) or real_ik(spec, t, s))
    out, traces = {}, {}
    for kept in (True, False):
        runner = _runner(sim)
        traces[kept] = []
        with monkeypatch.context() as m:
            if kept:
                ran = {}
                _fail_host_reads(m)
                _guard_after_first_call(m, KeptFunction, ("step",), ran)
            out[kept] = harness.run_batch_stepped(runner, starts, goals, zonos, masks,
                                                  torch.Generator().manual_seed(6),
                                                  collision_oracle="box", hlp="ee_rrt_star",
                                                  trace=traces[kept], eager=not kept)
        if kept:
            assert runner.programs.capacity == len(harness.STAGES) + 3     # FK buckets 1, 2, 4
            assert not runner.programs.entries and sorted(ran.values()) == [1, 1, 1, 1]
    _assert_same_summary(out[True], out[False])
    assert rows == [3] * 4                          # every iteration, kept and eager
    tr = traces[True]
    assert [t["ee_worlds"] for t in tr] == [2, 1]
    assert [t["stage_misses"] for t in tr] == [4, 0] and [t["stage_hits"] for t in tr] == [0, 4]
    assert tr[1]["stage_hits_by_name"] == {"reference": 1, "ee": 1, "ik": 1, "move_and_check": 1}
    assert all(t["stage_evictions"] == 0 for t in tr)
