"""Parity of the port's smooth-collision mode with the JAX package, on the
CPU: the smooth (log-sum-exp) collision constraint and the differentiable
hard-max values on a JAX-built bank (float64, and float32 with bf16
normals); ``ArmourPlanner`` in smooth-collision mode end to end, the JAX
random starts injected through ``k_rand``.  The grasp mode and
``solve_box_alm`` are in `tests/test_torch_modes_grasp.py`, so that the two
files' JAX planners compile side by side.

Tolerances: float64 values and Jacobians at atol 1e-11; float32 values at
2e-6 and Jacobians at 2e-4 (the softmax divides piece differences by
tau = 1e-3, which magnifies float32 rounding a thousandfold); plans:
``feasible`` equal and k within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.collision.zonotope import collision_constraint_values as jax_values
from armour_tpu.collision.zonotope import smooth_collision_constraints_with_jac as jax_smooth
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.collision import kernels
from armour_tpu_torch.collision.zonotope import (
    ObstacleSet,
    collision_constraint_values,
    collision_values_multi,
    smooth_collision_constraints_with_jac,
)
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from test_torch_collision import TORCH_DTYPE, _build_problem, _port

Q_HOME = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
TAU = 1e-3
BLOCKED = ([[0.0, 0.0, 0.6]], [[3.0, 3.0, 1.5]])            # a box engulfing the workspace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are a few worlds wide: one intra-op thread
    runs them as fast as eight, and leaves the cores to the JAX compiles
    and to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def problem64():
    """`tests/test_torch_collision.py`'s JAX-built problem in float64."""
    return _build_problem(np.random.default_rng(0), jnp.float64)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32-bf16"])
def test_smooth_and_hard_values_match_jax(rng, dtype, problem64):
    prob = problem64 if dtype == jnp.float64 else _build_problem(rng, dtype)
    links, hp = _port(prob, dtype)
    assert hp.A.dtype == (torch.bfloat16 if dtype == jnp.float32 else torch.float64)
    S = 3
    K = rng.uniform(-0.9, 0.9, (S, 7))
    centers, _, dcenters = prob.links.slice_with_jac_multi(jnp.asarray(K, dtype))
    g_j, J_j = jax.vmap(lambda c, dc: jax_smooth(prob.hp, c, dc, TAU))(centers, dcenters)
    v_j = jax.vmap(lambda c: jax_values(prob.hp, c))(centers)          # (S, T, L, O)
    c_t, _, dc_t = links.slice_with_jac_multi(torch.as_tensor(K, dtype=TORCH_DTYPE[dtype])[None])
    g_t, J_t = smooth_collision_constraints_with_jac(hp, c_t, dc_t, TAU)  # (1,S,L,O,T), (1,S,n,L,O,T)
    v_t = collision_constraint_values(hp, c_t)
    atol_g, atol_J = (1e-11, 1e-11) if dtype == jnp.float64 else (2e-6, 2e-4)
    np.testing.assert_allclose(np.asarray(g_j), g_t[0].permute(0, 3, 1, 2).numpy(), rtol=0, atol=atol_g)
    np.testing.assert_allclose(np.asarray(J_j), J_t[0].permute(0, 4, 2, 3, 1).numpy(), rtol=0, atol=atol_J)
    np.testing.assert_allclose(np.asarray(v_j), v_t[0].permute(0, 3, 1, 2).numpy(), rtol=0, atol=atol_g)
    # the smooth bound is conservative, within tau * log(2P) of the hard max
    hard = collision_values_multi(hp, c_t)
    live = hp.obs_mask[:, None, None, :, None].expand_as(hard)
    assert torch.equal(hard, v_t)
    assert bool((g_t[live] >= hard[live] - atol_g).all())
    assert bool((g_t[live] <= hard[live] + TAU * np.log(72.0) + atol_g).all())


def test_smooth_chunking_over_starts_changes_nothing(rng, monkeypatch, problem64):
    from armour_tpu_torch.collision import zonotope

    links, hp = _port(problem64, jnp.float64)
    c_t, _, dc_t = links.slice_with_jac_multi(torch.as_tensor(rng.uniform(-0.9, 0.9, (1, 5, 7))))
    whole = smooth_collision_constraints_with_jac(hp, c_t, dc_t, TAU)
    per_start = 2 * 36 * np.prod(hp.dpos.shape[2:]) * 8
    monkeypatch.setattr(zonotope, "_SMOOTH_PIECES_BYTES", 2 * per_start)    # chunks of 2, 2, 1
    chunked = smooth_collision_constraints_with_jac(hp, c_t, dc_t, TAU)
    assert torch.equal(whole[0], chunked[0])
    # the Jacobian's contractions sum in another order at another batch size
    np.testing.assert_allclose(whole[1].numpy(), chunked[1].numpy(), rtol=0, atol=1e-14)


def _starts(key, n_rand):
    return np.array(jax.random.uniform(key, (n_rand, 7), jnp.float64, minval=-0.6, maxval=0.6))


@pytest.fixture(scope="module")
def smooth_planners():
    kw = dict(num_time_steps=16, max_obstacles=4, nlp_num_starts=4, nlp_outer_iters=8,
              nlp_inner_iters=8, smooth_collision_tau=TAU)
    return (JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**kw)),
            ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**kw), dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("world", ["two_boxes", "blocked"])
def test_plan_smooth_mode_matches_jax(smooth_planners, world):
    jp, tp = smooth_planners
    centers, sides = (BLOCKED if world == "blocked" else
                      ([[0.4, 0.2, 0.3], [0.1, -0.4, 0.5]], [[0.1, 0.1, 0.1], [0.2, 0.1, 0.15]]))
    qd0 = np.random.default_rng(0).uniform(-0.3, 0.3, 7)
    q_des = Q_HOME + 0.8 * jp.cfg.k_range
    key = jax.random.PRNGKey(0)
    res_j = jp.plan(Q_HOME, qd0, np.zeros(7), q_des,
                    JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 4), key)
    kernels.reset_launch_counts()
    res_t = tp.plan(Q_HOME, qd0, np.zeros(7), q_des, ObstacleSet.from_boxes(centers, sides, 4),
                    k_rand=_starts(key, 2))
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}
    assert bool(res_j.feasible) == bool(res_t.feasible) == (world != "blocked")
    if world == "blocked":
        assert np.all(np.isnan(res_t.k.numpy()))
    else:
        np.testing.assert_allclose(np.asarray(res_j.k), res_t.k.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(res_j.max_violation), float(res_t.max_violation),
                                   rtol=0, atol=1e-8)
