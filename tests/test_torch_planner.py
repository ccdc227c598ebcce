"""Parity of the port's NLP solver and planner with the JAX package, on the
CPU in float64 (the multi-start ALM and the culled batch are in
`tests/test_torch_planner_batch.py`, so that the two files' JAX compiles
run side by side).

- ``ArmourPlanner.solve`` on a problem the JAX planner built, carried over
  by ``armour_tpu_torch.convert``: the same verdict, k at atol 1e-8.
- ``ArmourPlanner.plan`` end to end on `tests/test_planner.py`'s
  configuration (T=16, 4 obstacle slots), with the JAX random starts
  injected: the same ``feasible``, k at atol 1e-6, ``torque_radius`` at
  rtol 1e-9.

The JAX side runs its portable XLA path on the CPU, never Pallas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch import convert
from armour_tpu_torch.collision import kernels
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

CFG_KW = dict(num_time_steps=16, max_obstacles=4, nlp_num_starts=4,
              nlp_outer_iters=8, nlp_inner_iters=8)
Q_HOME = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
N_RAND = CFG_KW["nlp_num_starts"] - 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are a few worlds wide: one intra-op thread
    runs them as fast as eight, and leaves the cores to the JAX compiles
    and to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _jax_starts(key):
    """The random starts the JAX solve draws from ``key`` (`armour.py:470`)."""
    return np.asarray(jax.random.uniform(key, (N_RAND, 7), jnp.float64, minval=-0.6, maxval=0.6))


@pytest.fixture(scope="module")
def planners():
    cfg_j, cfg_t = JaxPlannerConfig(**CFG_KW), PlannerConfig(**CFG_KW)
    return (JaxPlanner(jax_kinova_gen3_spec(), cfg_j),
            ArmourPlanner(kinova_gen3_spec(), cfg_t, dtype=torch.float64, device="cpu"))


def test_solve_on_jax_built_problem_matches_jax(planners, rng):
    """The JAX planner's built problem (reachable sets + bank), carried over
    by convert.problem_from_numpy, solved by both packages."""
    jp, tp = planners
    qd0 = rng.uniform(-0.3, 0.3, 7)
    obs = JaxObstacleSet.from_boxes(np.array([[0.4, 0.2, 0.3], [0.1, -0.4, 0.5]]),
                                    np.array([[0.1, 0.1, 0.1], [0.2, 0.1, 0.15]]), 4)
    prob = jax.jit(jp._make_build_fn())(jnp.asarray(Q_HOME), jnp.asarray(qd0), jnp.zeros(7),
                                        obs.zonos, obs.mask)
    q_des = Q_HOME + 0.8 * jp.cfg.k_range
    key = jax.random.PRNGKey(3)
    res_j = jax.jit(jp._make_solve_fn())(prob, jnp.asarray(q_des), key, jnp.zeros(7))

    def pz(p):
        return (np.asarray(p.c), np.asarray(p.G), np.asarray(p.r), p.basis)

    prob_t = convert.problem_from_numpy(
        links=pz(prob.links), u=pz(prob.u),
        hp=(prob.hp.A, prob.hp.dpos, prob.hp.dneg, prob.hp.obs_mask),
        t_rad=prob.t_rad, q0=prob.q0, qd0=prob.qd0, Tqd0=prob.Tqd0, TTqdd0=prob.TTqdd0,
        k_range=prob.k_range, device="cpu", dtype=torch.float64)
    res_t = tp.solve(prob_t, q_des[None], k_rand=_jax_starts(key)[None])
    assert bool(res_j.feasible) == bool(res_t.feasible[0])
    np.testing.assert_allclose(np.asarray(res_j.k), res_t.k[0].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(res_j.cost), float(res_t.cost[0]), rtol=0, atol=1e-8)


def _home_frames():
    """Joint frame origins of the home pose (JAX point FK)."""
    from armour_tpu.dynamics.rnea import forward_kinematics

    return np.array(forward_kinematics(jax_kinova_gen3_spec(), jnp.asarray(Q_HOME))[1])


def _worlds():
    """name -> (box centers, side lengths, goal as a multiple of k_range,
    initial joint velocity)."""
    ee = _home_frames()[-1]
    qd0 = np.random.default_rng(0).uniform(-0.3, 0.3, 7)
    return {
        # a box 20 cm above the wrist
        "near_ee": ([ee + np.array([0.0, 0.0, 0.2])], [[0.1, 0.1, 0.1]], 0.9, np.zeros(7)),
        "two_boxes": ([[0.4, 0.2, 0.3], [0.1, -0.4, 0.5]],
                      [[0.1, 0.1, 0.1], [0.2, 0.1, 0.15]], 0.8, qd0),
        # a box engulfing the workspace: no feasible plan
        "blocked": ([[0.0, 0.0, 0.6]], [[3.0, 3.0, 1.5]], None, np.zeros(7)),
    }


@pytest.mark.parametrize("world", ["near_ee", "two_boxes", "blocked"])
def test_plan_matches_jax(planners, world):
    jp, tp = planners
    centers, sides, goal, qd0 = _worlds()[world]
    q_des = Q_HOME + (0.03 if goal is None else goal * jp.cfg.k_range)
    key = jax.random.PRNGKey(0)
    res_j = jp.plan(Q_HOME, qd0, np.zeros(7), q_des,
                    JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 4), key)
    kernels.reset_launch_counts()
    res_t = tp.plan(Q_HOME, qd0, np.zeros(7), q_des,
                    ObstacleSet.from_boxes(centers, sides, 4), k_rand=_jax_starts(key))
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}
    assert bool(res_j.feasible) == bool(res_t.feasible)
    if goal is None:
        assert not bool(res_t.feasible) and np.all(np.isnan(res_t.k.numpy()))
    else:
        assert bool(res_t.feasible)
        np.testing.assert_allclose(np.asarray(res_j.k), res_t.k.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_j.torque_radius), res_t.torque_radius.numpy(),
                               rtol=1e-9, atol=0)
