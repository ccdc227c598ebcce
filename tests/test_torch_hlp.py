"""Parity of the port's high-level planners with the JAX package, on the
CPU in float64, on the same numpy-seeded inputs:

- ``_host_checker``: equal booleans (and equal to the port's
  ``arm_collision_check``);
- ``rrt_waypoints``, ``rrt_star_waypoints``, ``rrt_connect_waypoints``,
  ``prm_waypoints`` at the same seed: the same path, atol 1e-12;
- ``straight_line_waypoint`` and ``clearance_waypoint`` (batched over
  worlds, given the JAX package's ``jax.random.normal`` draws): atol 1e-12;
- ``ik_to_position`` (batched): q within 1e-9, equal ``ok``;
- ``ee_rrt_star_waypoints`` / ``ee_rrt_star_config_waypoints``: the same
  path within 1e-9;
- ``ManualWaypointHLP``: the same waypoint sequence;
- ``optimization_waypoint``: the waypoint within 1e-6, equal ``ok``.
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
from armour_tpu_torch.planner import hlp
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.world import arm_collision_check

SPEC, JSPEC = kinova_gen3_spec(), jax_kinova_gen3_spec()
Q_HOME = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
MID = (np.array([[0.45, 0.35, 0.55]]), np.array([[0.12, 0.12, 0.12]]))   # on the straight route


def _both(centers, sides, cap=4):
    return (ObstacleSet.from_boxes(centers, sides, cap),
            JaxObstacleSet.from_boxes(centers, sides, cap))


def _same_path(got, want, atol):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_host_checker_matches_jax_and_the_oracle(rng):
    centers = rng.uniform(-0.7, 0.7, (6, 3))
    centers[:, 2] = np.abs(centers[:, 2]) + 0.1
    obs, jobs = _both(centers, rng.uniform(0.05, 0.4, (6, 3)), 8)
    q = rng.uniform(-2.5, 2.5, (300, 7))
    got = hlp._host_checker(SPEC, obs)(q)
    np.testing.assert_array_equal(got, jax_hlp._host_checker(JSPEC, jobs)(q))
    oracle = arm_collision_check(SPEC, torch.as_tensor(q),
                                 ObstacleSet(torch.as_tensor(obs.zonos), torch.as_tensor(obs.mask)))
    np.testing.assert_array_equal(got, oracle.numpy())
    assert 10 < got.sum() < 290
    empty, _ = _both(np.zeros((0, 3)), np.zeros((0, 3)))
    assert not hlp._host_checker(SPEC, empty)(q).any()


@pytest.mark.parametrize("name, kw", [
    ("rrt_waypoints", dict(max_nodes=500, step=0.4)),
    ("rrt_star_waypoints", dict(max_nodes=300, step=0.35)),
    ("rrt_connect_waypoints", dict(max_nodes=400, step=0.35)),
    ("prm_waypoints", dict(n_samples=150, k_neighbors=8)),
])
def test_config_planners_match_jax(name, kw):
    obs, jobs = _both(*MID)
    goal = Q_HOME + 0.8
    for seed in (0, 3):
        got = getattr(hlp, name)(SPEC, Q_HOME, goal, obs, seed=seed, **kw)
        want = getattr(jax_hlp, name)(JSPEC, Q_HOME, goal, jobs, seed=seed, **kw)
        assert got is not None
        _same_path(got, want, 1e-12)
        np.testing.assert_allclose(got[0], Q_HOME, atol=1e-12)
        np.testing.assert_allclose(got[-1], goal, atol=1e-12)


def test_edge_free_matches_jax(rng):
    obs, jobs = _both(*MID)
    a, b = rng.uniform(-2, 2, (20, 7)), rng.uniform(-2, 2, (20, 7))
    np.testing.assert_array_equal(
        hlp._edge_free(hlp._host_checker(SPEC, obs), a, b),
        jax_hlp._edge_free(jax_hlp._host_checker(JSPEC, jobs), a, b))


def test_straight_line_and_clearance_waypoints_match_jax(rng):
    B = 3
    q = Q_HOME + rng.uniform(-0.3, 0.3, (B, 7))
    goal = q + rng.uniform(-2.0, 2.0, (B, 7))
    goal[0, 0] = q[0, 0] + 3.5                     # across the seam of a continuous joint
    want = jax.vmap(lambda a, b: jax_hlp.straight_line_waypoint(JSPEC, a, b))(jnp.asarray(q),
                                                                               jnp.asarray(goal))
    got = hlp.straight_line_waypoint(SPEC, torch.as_tensor(q), torch.as_tensor(goal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # world 0: open; worlds 1, 2: a box in front of the arm blocks part of
    # the candidates (world 2's engulfs everything: straight-line fallback)
    boxes = [([[5.0, 5.0, 5.0]], [[0.1, 0.1, 0.1]]), MID, ([[0.0, 0.0, 0.5]], [[4.0, 4.0, 4.0]])]
    obs = [_both(np.asarray(c), np.asarray(s)) for c, s in boxes]
    zonos = np.stack([o[0].zonos for o in obs])
    masks = np.stack([o[0].mask for o in obs])
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    noise = jax.vmap(lambda k: jax.random.normal(k, (32, 7), jnp.float64))(keys)
    want = jax.vmap(lambda a, b, z, m, k: jax_hlp.clearance_waypoint(
        JSPEC, a, b, JaxObstacleSet(z, m), k))(jnp.asarray(q), jnp.asarray(goal),
                                              jnp.asarray(zonos), jnp.asarray(masks), keys)
    got = hlp.clearance_waypoint(SPEC, torch.as_tensor(q), torch.as_tensor(goal),
                                 ObstacleSet(torch.as_tensor(zonos), torch.as_tensor(masks)),
                                 noise=torch.as_tensor(np.array(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    base = hlp.straight_line_waypoint(SPEC, torch.as_tensor(q), torch.as_tensor(goal))
    assert torch.equal(got[2], base[2])             # everything collides: the straight line
    assert not torch.equal(got[1], base[1])         # the straight line collides: a sample
    # drawn from a generator: the same generator state gives the same pick
    obs_t = ObstacleSet(torch.as_tensor(zonos), torch.as_tensor(masks))
    a = hlp.clearance_waypoint(SPEC, torch.as_tensor(q), torch.as_tensor(goal), obs_t,
                               generator=torch.Generator().manual_seed(1))
    b = hlp.clearance_waypoint(SPEC, torch.as_tensor(q), torch.as_tensor(goal), obs_t,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_ik_to_position_matches_jax(rng):
    from armour_tpu_torch.dynamics.utility import ee_pose

    B = 4
    q_true = Q_HOME + rng.uniform(-0.4, 0.4, (B, 7))
    targets = ee_pose(SPEC, torch.as_tensor(q_true))[1].numpy()
    targets[3] = [3.0, 0.0, 0.5]                    # out of reach: ok is False
    seeds = Q_HOME + rng.uniform(-0.2, 0.2, (B, 7))
    q_j, ok_j = jax.jit(jax.vmap(lambda t, s: jax_hlp.ik_to_position(JSPEC, t, s)))(
        jnp.asarray(targets), jnp.asarray(seeds))
    q_t, ok_t = hlp.ik_to_position(SPEC, torch.as_tensor(targets), torch.as_tensor(seeds))
    # out of reach, the iteration saturates on the joint box and amplifies
    # rounding: q is compared where the target is reachable, ok everywhere
    np.testing.assert_allclose(q_t[:3].numpy(), np.asarray(q_j)[:3], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t[:3].all() and not ok_t[3]


def test_ee_rrt_star_paths_match_jax():
    obs, jobs = _both(*MID)
    q_goal = Q_HOME + 4.0 * np.pi / 48 * np.ones(7) * 2
    want = jax_hlp.ee_rrt_star_waypoints(JSPEC, Q_HOME, q_goal, jobs, seed=2)
    got = hlp.ee_rrt_star_waypoints(SPEC, Q_HOME, q_goal, obs, seed=2)
    assert got is not None and got.shape[1] == 3
    _same_path(got, want, 1e-9)
    # a 3-D goal point
    point = got[len(got) // 2]
    _same_path(hlp.ee_rrt_star_waypoints(SPEC, Q_HOME, point, obs, seed=4),
               jax_hlp.ee_rrt_star_waypoints(JSPEC, Q_HOME, point, jobs, seed=4), 1e-9)
    want = jax_hlp.ee_rrt_star_config_waypoints(JSPEC, Q_HOME, q_goal, jobs, seed=2)
    got = hlp.ee_rrt_star_config_waypoints(SPEC, Q_HOME, q_goal, obs, seed=2)
    _same_path(got, want, 1e-9)
    np.testing.assert_allclose(got[-1], q_goal, atol=1e-12)


def test_manual_waypoint_hlp_matches_jax():
    wps = np.stack([np.zeros(7), np.full(7, 0.5), np.full(7, 1.0)])
    port, ref = hlp.ManualWaypointHLP(wps, 0.3), jax_hlp.ManualWaypointHLP(wps, 0.3)
    for q in (np.full(7, -2.0), np.zeros(7), np.full(7, 0.5), np.full(7, 0.45), np.full(7, 1.0)):
        np.testing.assert_array_equal(port.get_waypoint(torch.as_tensor(q)), ref.get_waypoint(q))
        assert port.index == ref.index


def test_optimization_waypoint_matches_jax():
    """On these seeded cases the Newton systems of the small NLP stay
    solvable alike in both packages.  Where its cost Hessian is indefinite
    (the EE-distance cost over a k-box of +-1000 rad on the continuous
    joints), the JAX package's clamped Cholesky and the port's library
    factorisation give different steps (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    obs, jobs = _both(np.array([[-0.3, 0.1, 0.5]]), np.array([[0.15, 0.15, 0.15]]))
    for _ in range(2):
        q_start = Q_HOME + rng.uniform(-0.3, 0.3, 7)
        q_goal = q_start + rng.uniform(-0.5, 0.5, 7)
        want, ok_j = jax_hlp.optimization_waypoint(JSPEC, q_start, q_goal, jobs, buffer_dist=0.08,
                                                   outer_iters=4, inner_iters=6)
        got, ok_t = hlp.optimization_waypoint(SPEC, q_start, q_goal, obs, buffer_dist=0.08,
                                              outer_iters=4, inner_iters=6, device="cpu")
        assert ok_t == ok_j
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
