"""Parity of the port's scenario layer and goal tests with the JAX package,
on the CPU in float64: the CSV world loader and writer, the seven hard
scenes, the numpy-seeded random world and suite, ``stack_worlds``, and
``goal_check`` / ``goal_check_ee``; ``random_world`` by its properties (the
JAX package draws it from a ``jax.random`` key, the port from a
``torch.Generator``).

Tolerances: the scene constructors and loaders run the same numpy code and
must give EQUAL arrays; the goal tests agree within 1e-12 on their
distances and exactly on their verdicts.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu.sim import scenarios as jax_scn
from armour_tpu.sim import world as jax_world
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import scenarios, world

SPEC, JSPEC = kinova_gen3_spec(), jax_kinova_gen3_spec()
WORLDS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "assets", "worlds", "*.csv")))


def _same_world(jw, tw):
    for a, b in ((jw.start, tw.start), (jw.goal, tw.goal), (jw.obstacles.zonos, tw.obstacles.zonos),
                 (jw.obstacles.mask, tw.obstacles.mask)):
        assert isinstance(b, torch.Tensor) and b.device == torch.device("cpu")
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("index", [0, 40, 99])
def test_load_world_csv_matches_jax(index):
    assert len(WORLDS) == 100
    path = WORLDS[index]
    _same_world(jax_scn.load_world_csv(path, 40), scenarios.load_world_csv(path, 40, device="cpu"))
    w32 = scenarios.load_world_csv(path, 40, dtype=torch.float32, device="cpu")
    assert w32.start.dtype == w32.obstacles.zonos.dtype == torch.float32


def test_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    start, goal = rng.uniform(-2, 2, 7), rng.uniform(-2, 2, 7)
    centers, sides = rng.uniform(-0.8, 0.8, (3, 3)), rng.uniform(0.05, 0.4, (3, 3))
    scenarios.save_world_csv(tmp_path / "port.csv", start, goal, centers, sides)
    jax_scn.save_world_csv(tmp_path / "jax.csv", start, goal, centers, sides)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    w = scenarios.load_world_csv(tmp_path / "port.csv", 8, device="cpu")
    np.testing.assert_allclose(w.start.numpy(), start, atol=1e-5)
    np.testing.assert_allclose(w.obstacles.zonos[:3, 0].numpy(), centers, atol=1e-5)
    np.testing.assert_allclose(w.obstacles.zonos[:3, 1:].abs().sum(1).numpy() * 2, sides, atol=1e-5)
    assert int(w.obstacles.mask.sum()) == 3
    # a world without obstacles (the JAX loader cannot read one)
    scenarios.save_world_csv(tmp_path / "empty.csv", start, goal, [], [])
    empty = scenarios.load_world_csv(tmp_path / "empty.csv", 8, device="cpu")
    assert not empty.obstacles.mask.any() and not empty.obstacles.zonos.any()


@pytest.mark.parametrize("idx", range(1, 8))
def test_hard_scenario_matches_jax(idx):
    tw = scenarios.hard_scenario(idx, device="cpu")
    _same_world(jax_scn.hard_scenario(idx), tw)
    # the start configuration is collision-free in every scene
    assert not bool(world.arm_collision_check(SPEC, tw.start[None], tw.obstacles)[0])


def test_unknown_hard_scenario_raises():
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.hard_scenario(8, device="cpu")


def test_generate_random_world_and_suite_match_jax(tmp_path):
    # the JAX screen runs eagerly, a few seconds per obstacle: small counts
    jw = jax_scn.generate_random_world(JSPEC, np.random.default_rng(3), 6, 40)
    tw = scenarios.generate_random_world(SPEC, np.random.default_rng(3), 6, 40, device="cpu")
    _same_world(jw, tw)
    assert int(tw.obstacles.mask.sum()) == 6
    jp = jax_scn.generate_world_suite(JSPEC, tmp_path / "jax", n_worlds=2, obstacle_counts=(3, 4),
                                      seed=1)
    tp = scenarios.generate_world_suite(SPEC, tmp_path / "port", n_worlds=2, obstacle_counts=(3, 4),
                                        seed=1)
    assert [p.name for p in jp] == [p.name for p in tp]
    for a, b in zip(jp, tp):
        assert a.read_text() == b.read_text()


def test_stack_worlds_matches_jax():
    jws = [jax_scn.load_world_csv(p, 40) for p in WORLDS[:3]]
    tws = [scenarios.load_world_csv(p, 40, device="cpu") for p in WORLDS[:3]]
    for a, b in zip(jax_scn.stack_worlds(jws), scenarios.stack_worlds(tws)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    starts32 = scenarios.stack_worlds(tws, torch.float32)[0]
    assert starts32.dtype == torch.float32 and starts32.shape == (3, 7)


def test_goal_checks_match_jax():
    rng = np.random.default_rng(0)
    goal = rng.uniform(-2.5, 2.5, 7)
    # around the goal at the decision radius, and across the +-pi seam of
    # the continuous joints
    q = goal + rng.uniform(-0.15, 0.15, (64, 7))
    q[:8, 0] = goal[0] + 2 * np.pi + rng.uniform(-0.05, 0.05, 8)
    radius = np.pi / 30
    want = np.asarray(jax_world.goal_check(JSPEC, jnp.asarray(q), jnp.asarray(goal), radius))
    got = world.goal_check(SPEC, torch.as_tensor(q), torch.as_tensor(goal), radius).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 64
    # the end-effector goal: the decision and the distance it is made on
    target = rng.uniform(-0.5, 0.5, 3) + np.array([0.0, 0.0, 0.6])
    for r in (0.05, 0.6, 0.9):
        want = np.asarray(jax_world.goal_check_ee(JSPEC, jnp.asarray(q), jnp.asarray(target), r))
        got = world.goal_check_ee(SPEC, torch.as_tensor(q), torch.as_tensor(target), r).numpy()
        np.testing.assert_array_equal(got, want)
    from armour_tpu.dynamics.utility import ee_pose as jax_ee_pose
    from armour_tpu_torch.dynamics.utility import ee_pose

    np.testing.assert_allclose(ee_pose(SPEC, torch.as_tensor(q))[1].numpy(),
                               np.asarray(jax_ee_pose(JSPEC, jnp.asarray(q))[1]), rtol=0, atol=1e-12)


def test_wrap_is_the_mod_form_at_the_seam():
    from armour_tpu_torch.planner.armour import wrap_to_pi

    x = torch.tensor([np.pi, -np.pi, 3 * np.pi, 0.5], dtype=torch.float64)
    want = np.asarray(jax_world._wrap(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(wrap_to_pi(x).numpy(), want)
    assert wrap_to_pi(x)[0].item() == -np.pi        # atan2 would give +pi


def test_random_world_properties():
    gen = torch.Generator().manual_seed(4)
    w = world.random_world(SPEC, 6, 10, gen, device="cpu")
    lb = np.where(SPEC.continuous_joints, -np.pi, SPEC.pos_limits_lb + 0.05)
    ub = np.where(SPEC.continuous_joints, np.pi, SPEC.pos_limits_ub - 0.05)
    for q in (w.start.numpy(), w.goal.numpy()):
        assert np.all(q >= lb) and np.all(q <= ub)
    z, m = w.obstacles.zonos.numpy(), w.obstacles.mask.numpy()
    assert z.shape == (10, 4, 3) and m.tolist() == [True] * 6 + [False] * 4
    assert np.all(np.abs(z[:6, 0, :2]) <= 0.9) and np.all(z[:6, 0, 2] >= 0.1)
    half = z[:6, 1:]
    sides = 2 * np.diagonal(half, axis1=1, axis2=2)
    assert np.all(sides >= 0.01) and np.all(sides <= 0.5)
    assert np.count_nonzero(half) == 18 and not z[6:].any()
    # a fresh generator with the same seed draws the same world; the next
    # draw of the same generator differs
    again = world.random_world(SPEC, 6, 10, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(again.obstacles.zonos, w.obstacles.zonos)
    assert not torch.equal(world.random_world(SPEC, 6, 10, gen, device="cpu").start, w.start)
