"""Parity of the port's battery driver with the JAX package, on the CPU in
float64: ``run_batch_stepped`` on two worlds at T=16 with
``SimConfig(plant_dt=5e-3, max_iterations=3, stall_clearance=1)`` and the
exact mesh oracle, the port fed the JAX package's draws (true parameters,
random starts, clearance samples).  World 0 is the first assets world cut
to 7 obstacles (bucket 8: the JAX driver compiles one solve); world 1
holds a 1 cm box inside a link's bounding box at its start, so the box
screen flags every window, the mesh oracle clears it (the refinement runs),
every plan is infeasible and the stalled world takes clearance waypoints.

Held equal: every flag, ``iterations`` and ``n_feasible_plans``; the
overshoot magnitudes within 1e-9.  The episode program
(``EpisodeRunner.run_batch``) is held to the JAX package's on the same two
worlds in `test_torch_harness_scan.py`.

Also: without injected draws, the random starts change from replan to
replan in every driver (one generator lives for the whole episode), and the
same seed repeats them.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.config import SimConfig as JaxSimConfig
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu.sim import harness as jax_harness
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.planner.armour import PlanResult
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import harness
from armour_tpu_torch.sim.recording import run_recorded_episode
from armour_tpu_torch.sim.scenarios import load_world_csv
from armour_tpu_torch.sim.world import World

SPEC, JSPEC = kinova_gen3_spec(), jax_kinova_gen3_spec()
PCFG = dict(num_time_steps=16)
SCFG = dict(plant_dt=5e-3, max_iterations=3, stall_clearance=1)
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "worlds")
FLAGS = ("goal_reached", "collision", "torque_violation", "joint_limit_violation",
         "ultimate_bound_violation", "stopped", "iterations", "n_feasible_plans")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are a few worlds wide: one intra-op thread
    runs them as fast as eight, and leaves the cores to the JAX compiles
    and to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_worlds():
    """numpy (starts, goals, zonos (2, 40, 4, 3), masks) of the two worlds."""
    w0 = load_world_csv(sorted(glob.glob(os.path.join(ASSETS, "*.csv")))[0], 40, device="cpu")
    z0, m0 = w0.obstacles.zonos.numpy().copy(), w0.obstacles.mask.numpy().copy()
    z0[7:], m0[7:] = 0.0, False
    start1 = np.array([0.3, 0.4, 0.0, -1.2, 0.0, 0.5, 0.0])
    Rw, pw = forward_kinematics(SPEC, torch.as_tensor(start1))
    link = 3
    center = (Rw[link] @ torch.as_tensor(SPEC.link_zono_center[link]) + pw[link]).numpy()
    assert np.all(np.asarray(SPEC.link_zono_gen[link]) > 0.02)
    obs1 = ObstacleSet.from_boxes(center[None], [[0.01, 0.01, 0.01]], 40)
    starts = np.stack([w0.start.numpy(), start1])
    goals = np.stack([w0.goal.numpy(), start1 + 0.8])
    return starts, goals, np.stack([z0, obs1.zonos]), np.stack([m0, obs1.mask])


def jax_draws(keys, n_iters, n_starts):
    """The JAX stepped driver's key stream (`harness.py:484-494, 667, 759,
    782`) turned into the port's explicit draws."""
    f64 = jnp.float64
    lo, hi = JaxSimConfig().uncertain_mass_range
    kt = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    tp = [np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (7,), f64, lo, hi))(kt[:, j]))
          for j in (0, 1)]
    loop = kt[:, 2]
    out = []
    for _ in range(n_iters):
        wp = jax.vmap(lambda k: jax.random.split(k)[1])(loop)
        clear = jax.vmap(lambda k: jax.random.normal(k, (32, 7), f64))(wp)
        loop = jax.vmap(lambda k: jax.random.split(k)[0])(loop)
        k_rand = jax.vmap(lambda k: jax.random.uniform(k, (max(n_starts - 2, 1), 7), f64,
                                                       -0.6, 0.6))(loop)
        loop = jax.vmap(jax.random.split)(loop)[:, 0]
        out.append(harness.Draws(torch.as_tensor(np.array(k_rand)), torch.as_tensor(np.array(clear))))
    return harness.TrueParams(*(torch.as_tensor(np.array(x)) for x in tp)), out


@pytest.fixture(scope="module")
def stepped():
    """One JAX and one port run of the battery driver on the two worlds."""
    starts, goals, zonos, masks = two_worlds()
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jrunner = jax_harness.EpisodeRunner(JSPEC, JaxPlannerConfig(**PCFG), JaxSimConfig(**SCFG))
    want = jax_harness.run_batch_stepped(jrunner, jnp.asarray(starts), jnp.asarray(goals),
                                         jnp.asarray(zonos), jnp.asarray(masks), keys,
                                         collision_oracle="mesh")
    tp, draws = jax_draws(keys, SCFG["max_iterations"], PlannerConfig().nlp_num_starts)
    runner = harness.EpisodeRunner(SPEC, PlannerConfig(**PCFG), SimConfig(**SCFG), device="cpu")
    trace = []
    got = harness.run_batch_stepped(runner, starts, goals, zonos, masks, true_params=tp,
                                    draws=lambda i: draws[i], collision_oracle="mesh", trace=trace)
    return want, got, trace


def test_run_batch_stepped_matches_jax(stepped):
    want, got, trace = stepped
    for name in FLAGS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("jl_overshoot", "ub_overshoot", "torque_overshoot"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    # what the two worlds were built to exercise
    assert got.n_feasible_plans.tolist()[1] == 0 and got.n_feasible_plans[0] > 0
    assert not bool(got.collision.any()) and got.iterations.tolist() == [3, 3]
    assert sum(t["mesh_flagged"] for t in trace) == 3 and sum(t["mesh_confirmed"] for t in trace) == 0
    assert [t["clearance_worlds"] for t in trace] == [0, 0, 1]
    assert all(t["bucket"] == t["bucket_culled"] == 8 for t in trace)


def test_run_batch_stepped_box_oracle_keeps_the_screen_verdict(stepped):
    """With ``collision_oracle="box"`` world 1's flagged windows stay
    collisions: the episode ends after one iteration."""
    starts, goals, zonos, masks = two_worlds()
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    tp, draws = jax_draws(keys, 1, PlannerConfig().nlp_num_starts)
    runner = harness.EpisodeRunner(SPEC, PlannerConfig(**PCFG), SimConfig(**dict(SCFG, max_iterations=1)),
                                   device="cpu")
    got = harness.run_batch_stepped(runner, starts[1:], goals[1:], zonos[1:], masks[1:],
                                    true_params=harness.TrueParams(tp[0][1:], tp[1][1:]),
                                    draws=lambda i: harness.Draws(draws[i].k_rand[1:],
                                                                  draws[i].clearance_noise[1:]),
                                    collision_oracle="box")
    assert got.collision.tolist() == [True] and got.iterations.tolist() == [1]
    with pytest.raises(ValueError, match="collision_oracle"):
        harness.run_batch_stepped(runner, starts, goals, zonos, masks, collision_oracle="exact")


def _record_starts(monkeypatch, planner):
    """Replace ``planner.solve`` by a stub that records the random starts it
    is given (and returns an infeasible plan: braking)."""
    seen = []

    def solve(prob, q_des, k_rand=None, k_warm=None, generator=None):
        assert k_rand is not None
        seen.append(k_rand.clone())
        return _infeasible(prob)

    monkeypatch.setattr(planner, "solve", solve)
    return seen


def _infeasible(prob):
    B, dt = prob.q0.shape[0], prob.q0.dtype
    return PlanResult(k=torch.full((B, 7), torch.nan, dtype=dt), feasible=torch.zeros(B, dtype=torch.bool),
                      cost=torch.zeros(B, dtype=dt), max_violation=torch.zeros(B, dtype=dt),
                      torque_radius=prob.t_rad)


@pytest.mark.parametrize("driver", ["stepped", "scan", "recorded"])
def test_random_starts_change_between_replans(monkeypatch, driver):
    starts, goals, zonos, masks = two_worlds()
    sim = SimConfig(plant_dt=0.05, max_iterations=2)
    runs = []
    for _ in range(2):
        runner = harness.EpisodeRunner(SPEC, PlannerConfig(num_time_steps=8), sim, device="cpu")
        seen = _record_starts(monkeypatch, runner.planner)
        gen = torch.Generator().manual_seed(5)
        if driver == "stepped":
            harness.run_batch_stepped(runner, starts, goals, zonos, masks, gen, collision_oracle="box")
        elif driver == "scan":
            runner.run_batch(starts, goals, zonos, masks, gen)
        else:
            world = World(torch.as_tensor(starts[0]), torch.as_tensor(goals[0]),
                          ObstacleSet(torch.as_tensor(zonos[0]), torch.as_tensor(masks[0])))
            run_recorded_episode(SPEC, runner.plan_cfg, sim, world, gen, planner=runner.planner)
        assert len(seen) == 2
        assert not torch.equal(seen[0], seen[1])      # a fresh draw at every replan
        assert seen[0].abs().max() <= 0.6
        runs.append(seen)
    for a, b in zip(*runs):
        assert torch.equal(a, b)                      # the same seed repeats them
