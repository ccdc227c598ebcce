"""The kept episode steps on the CPU: ``EpisodeRunner.run_batch`` through
its ``EpisodeProgram`` (kept per (B, cap): the pre-plan step, the plan's
kept program, the post-plan step) and the battery driver's device stages
(``run_batch_stepped``: the reference state with the straight-line
waypoint, the clearance waypoint, the move and checks, each a
``KeptFunction`` per (B, bucket)).  On the CPU every step runs op by op
through the same buffers, keys and resets as on the card; only the capture
is card-only (`tests/test_torch_graphs_cuda.py` holds the replays).

Held to the bit: the kept runs against their op-by-op runs
(``eager=True``), every summary field and every plan, in both move modes and
both goal types, in the CPU's order (stall and done flags read on the host)
and in the card's (``EpisodeProgram.host_reads = False``: the clearance
waypoint of every world selected in the step, the done flag read one
iteration late).  Three worlds at capacity 8: the first assets world cut to
7 obstacles with its goal 0.3 rad from its start in every joint, a world
whose every plan is infeasible (a 1 cm box 1.5 cm off a link's bounding
box) that takes the clearance waypoint at its fourth replan and stops, and
the first world again with its goal 0.06 rad from its start.  Also: the
second call of each kept step makes no host traffic, and the drivers
release their programs.  T=16, a short ALM (2 x 4), no JAX here.
"""

import glob
import os

import numpy as np
import pytest
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import harness
from armour_tpu_torch.sim.scenarios import load_world_csv
from armour_tpu_torch.utils.graphs import KeptFunction, ProgramCache
from test_torch_batch_program import _bits, _guarded, _IN_STEP, one_torch_thread  # noqa: F401

SPEC = kinova_gen3_spec()
CFG = PlannerConfig(num_time_steps=16, nlp_outer_iters=2, nlp_inner_iters=4, max_obstacles=8)
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "worlds")


def three_worlds():
    """numpy (starts, goals, zonos (3, 8, 4, 3), masks)."""
    w0 = load_world_csv(sorted(glob.glob(os.path.join(ASSETS, "*.csv")))[0], 40, device="cpu")
    z0, m0 = w0.obstacles.zonos.numpy()[:8].copy(), w0.obstacles.mask.numpy()[:8].copy()
    z0[7:], m0[7:] = 0.0, False
    start1 = np.array([0.3, 0.4, 0.0, -1.2, 0.0, 0.5, 0.0])
    Rw, pw = forward_kinematics(SPEC, torch.as_tensor(start1))
    link = 3
    center = Rw[link] @ torch.as_tensor(SPEC.link_zono_center[link]) + pw[link]
    center = center + Rw[link][:, 0] * (SPEC.link_zono_gen[link][0] + 0.015)
    near = ObstacleSet.from_boxes(center.numpy()[None], [[0.01, 0.01, 0.01]], 8)
    s0 = w0.start.numpy()
    return (np.stack([s0, start1, s0]), np.stack([s0 + 0.3, start1 + 0.8, s0 + 0.06]),
            np.stack([z0, np.asarray(near.zonos), z0]), np.stack([m0, np.asarray(near.mask), m0]))


def _record_plans(monkeypatch, kept: bool) -> list:
    """Every plan of a run: ``run_program``'s for a kept run, the op-by-op
    ``solve``'s for an eager one."""
    plans = []
    name = "run_program" if kept else "solve"
    real = getattr(ArmourPlanner, name)

    def recorded(self, *args, **kw):
        out = real(self, *args, **kw)
        if kept or kw.get("eager"):
            plans.append((out[0] if kept else out)._replace(torque_radius=None))
        return out

    monkeypatch.setattr(ArmourPlanner, name, recorded)
    return plans


def _spy_programs(monkeypatch) -> list:
    """Every program that ``ProgramCache.run`` calls."""
    made = []
    real = ProgramCache.run

    def spied(self, key, make, *args, **kw):
        out = real(self, key, make, *args, **kw)
        made.append(self.entries[key])
        return out

    monkeypatch.setattr(ProgramCache, "run", spied)
    return made


def _assert_same_plans(kept, eager):
    for a, b in zip(kept, eager):
        for name in ("k", "feasible", "cost", "max_violation"):
            assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name))), name


def _assert_same_summary(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(_bits(x), _bits(y)), name


def _runner(sim, **kw):
    return harness.EpisodeRunner(SPEC, CFG, sim, device="cpu", **kw)


@pytest.mark.parametrize("move_mode, goal_type, host_reads, iterations", [
    ("integrator", "configuration", None, 4),
    ("direct", "end_effector_location", False, 5),
], ids=["integrator-config-cpu_order", "direct-ee-card_order"])
def test_kept_run_batch_equals_eager(move_mode, goal_type, host_reads, iterations, monkeypatch):
    """Every summary field and every plan to the bit.  World 1 takes the
    clearance waypoint at its fourth replan (an infeasible plan every
    time) and stops; world 2 reaches its goal at once, and in direct mode
    world 0 reaches its goal before world 1 stops, so in the card's order
    the kept loop runs one iteration more than the op-by-op one, which
    finds every world done and changes nothing."""
    monkeypatch.setattr(harness.EpisodeProgram, "host_reads", host_reads)
    starts, goals, zonos, masks = three_worlds()
    sim = SimConfig(plant_dt=0.05, max_iterations=iterations)
    out, plans, clearances = {}, {}, {}
    real_clearance = harness.clearance_waypoint
    for kept in (True, False):
        with monkeypatch.context() as m:
            plans[kept], clearances[kept] = _record_plans(m, kept), []
            m.setattr(harness, "clearance_waypoint",
                      lambda *a, _log=clearances[kept], **k: _log.append(1) or real_clearance(*a, **k))
            made = _spy_programs(m)
            runner = _runner(sim, move_mode=move_mode, goal_type=goal_type)
            out[kept] = runner.run_batch(starts, goals, zonos, masks, torch.Generator().manual_seed(3),
                                         eager=not kept)
        if kept:
            # the episode program and the plan program, released on return
            assert {type(p).__name__ for p in made} == {"EpisodeProgram", "PlanProgram"}
            assert all(p.steps == [] for p in made)
            assert not runner.programs.entries and not runner.planner.batch_programs.entries
            assert runner.programs.stats()["misses"] == 1
    _assert_same_summary(out[True], out[False])
    n_eager = len(plans[False])
    assert n_eager == int(out[False].iterations.max()) >= 4
    _assert_same_plans(plans[True], plans[False])
    # what the worlds were built to exercise
    assert out[False].stopped.tolist()[1] and out[False].n_feasible_plans.tolist()[1] == 0
    assert out[False].iterations.tolist()[1] == 4 and not bool(out[False].collision.any())
    assert bool(out[False].goal_reached[2])
    assert 1 <= len(clearances[False]) < n_eager
    if host_reads is None:
        # the CPU's order: the clearance waypoint only when a world stalled,
        # and no iteration after the last world ended
        assert len(clearances[True]) == len(clearances[False]) and len(plans[True]) == n_eager
    else:
        assert len(plans[True]) == len(clearances[True]) == n_eager + 1


def _guard_after_first_call(monkeypatch, cls, names, ran):
    """From the second call of each ``cls`` object on, its steps ``names``
    run under ``_guarded``; ``ran`` counts the guarded runs per object."""
    real = cls.__call__

    def call(self, *args, **kw):
        out = real(self, *args, **kw)
        if id(self) not in ran:
            ran[id(self)] = 0

            def counted(step):
                def run():
                    ran[id(self)] += 1
                    step()
                return run

            for name in names:
                if getattr(self, name) is not None:
                    setattr(self, name, _guarded(counted(getattr(self, name))))
        return out

    monkeypatch.setattr(cls, "__call__", call)


def _fail_host_reads(monkeypatch):
    for name in ("numpy", "tolist", "cpu"):
        real = getattr(torch.Tensor, name)

        def no_host(self, *a, _real=real, _n=name, **k):
            if _IN_STEP[0]:
                pytest.fail(f"Tensor.{_n} inside a kept step")
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, no_host)


@pytest.mark.parametrize("driver", ["run_batch", "run_batch_stepped"])
def test_second_call_of_each_kept_step_makes_no_host_traffic(driver, monkeypatch):
    """The episode program's pre-plan and post-plan steps (in the card's
    order, the clearance waypoint inside the pre-plan step) and the battery
    driver's three stages replay with no tensor made from host data and no
    host read of a device value."""
    starts, goals, zonos, masks = three_worlds()
    ran = {}
    monkeypatch.setattr(harness.EpisodeProgram, "host_reads", False)
    _fail_host_reads(monkeypatch)
    gen = torch.Generator().manual_seed(4)
    if driver == "run_batch":
        _guard_after_first_call(monkeypatch, harness.EpisodeProgram, ("pre_plan", "post_plan"), ran)
        _runner(SimConfig(plant_dt=0.05, max_iterations=2)).run_batch(starts, goals, zonos, masks, gen)
        assert list(ran.values()) == [2]
    else:
        _guard_after_first_call(monkeypatch, KeptFunction, ("step",), ran)
        # stall_clearance=0: every world takes the clearance waypoint at
        # every iteration, so each of the three stages replays once
        runner = _runner(SimConfig(plant_dt=0.05, max_iterations=2, stall_clearance=0))
        trace = []
        harness.run_batch_stepped(runner, starts[:2], goals[:2], zonos[:2], masks[:2], gen,
                                  collision_oracle="box", trace=trace)
        assert sorted(ran.values()) == [1, 1, 1]
        assert [t["clearance_worlds"] for t in trace] == [2, 2]
        assert [(t["stage_misses"], t["stage_hits"]) for t in trace] == [(3, 0), (0, 3)]
        assert not runner.programs.entries


def test_kept_battery_equals_eager(monkeypatch):
    """Two battery iterations with the box oracle: the summary (flags,
    counts and overshoots) and every plan to the bit."""
    starts, goals, zonos, masks = three_worlds()
    out, plans = {}, {}
    for kept in (True, False):
        with monkeypatch.context() as m:
            plans[kept] = _record_plans(m, kept)
            made = _spy_programs(m)
            runner = _runner(SimConfig(plant_dt=0.05, max_iterations=2))
            out[kept] = harness.run_batch_stepped(runner, starts, goals, zonos, masks,
                                                  torch.Generator().manual_seed(5),
                                                  collision_oracle="box", eager=not kept)
        if kept:
            assert {type(p).__name__ for p in made} == {"KeptFunction", "PlanProgram"}
            assert all(p.steps == [] for p in made) and not runner.programs.entries
    _assert_same_summary(out[True], out[False])
    assert len(plans[True]) == len(plans[False]) == 2
    _assert_same_plans(plans[True], plans[False])


def test_a_run_that_ends_early_gives_its_draws_back(monkeypatch):
    """In the card's order the kept loop runs one iteration after its last
    world ends, and gives the draws of that iteration back to the caller's
    generator.  Two calls on one generator, as ``run_worlds`` makes them
    chunk after chunk, each ending at its first iteration: the generator's
    state after each call, every plan and both summaries equal two op-by-op
    calls to the bit."""
    monkeypatch.setattr(harness.EpisodeProgram, "host_reads", False)
    worlds = [x[[2, 2]] for x in three_worlds()]
    out, plans, states = {}, {}, {}
    for kept in (True, False):
        with monkeypatch.context() as m:
            plans[kept], out[kept], states[kept] = _record_plans(m, kept), [], []
            runner = _runner(SimConfig(plant_dt=0.05, max_iterations=3))
            gen = torch.Generator().manual_seed(6)
            for _ in range(2):
                out[kept].append(runner.run_batch(*worlds, gen, eager=not kept))
                states[kept].append(gen.get_state())
    for a, b in zip(out[True], out[False]):
        _assert_same_summary(a, b)
    assert all(torch.equal(a, b) for a, b in zip(states[True], states[False]))
    assert [int(s.iterations.max()) for s in out[False]] == [1, 1]
    assert all(bool(s.goal_reached.all()) for s in out[False])
    # one plan per call op by op; the kept loop's second plan of each call
    # is the iteration that changed nothing
    assert len(plans[False]) == 2 and len(plans[True]) == 4
    _assert_same_plans(plans[True][::2], plans[False])
