"""Parity of the port's grasp mode and single-start ALM with the JAX
package, on the CPU (split from `tests/test_torch_modes.py`, whose helpers
it shares, along its module-scoped JAX planners): ``ArmourPlanner`` with
grasp constraints, end to end, the JAX random starts injected through
``k_rand``; and the single-start ``solve_box_alm`` on both of its routes.

Tolerances: plans: ``feasible`` equal and k within 1e-6; the grasp block at
the returned k <= 1e-6; ``solve_box_alm`` fields at 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.config import GraspConfig as JaxGraspConfig
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.planner.nlp import solve_box_alm as jax_solve_box_alm
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import GraspConfig, PlannerConfig
from armour_tpu_torch.planner import solve_box_alm
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from test_torch_modes import BLOCKED, Q_HOME, _starts, one_torch_thread  # noqa: F401 (a fixture)

Q_TRAY = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])   # end-effector z-axis up
FAR = ([[5.0, 5.0, 5.0]], [[0.1, 0.1, 0.1]])


@pytest.fixture(scope="module")
def grasp_planners():
    """`tests/test_extras.py`'s grasp configuration."""
    kw = dict(num_time_steps=8, max_obstacles=4, nlp_num_starts=2, nlp_outer_iters=6,
              nlp_inner_iters=6)
    g = dict(object_mass=0.2, u_s=0.6, surf_rad=0.03)
    return (JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**kw), grasp=JaxGraspConfig(**g)),
            ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**kw), dtype=torch.float64,
                          device="cpu", grasp=GraspConfig(**g)))


@pytest.mark.parametrize("world", ["tray_up", "tray_sideways", "blocked"])
def test_plan_with_grasp_matches_jax(grasp_planners, world):
    """Tray up: the contact constraints can hold.  At the home pose the tray
    is sideways and they cannot.  A blocked world is infeasible anyway."""
    jp, tp = grasp_planners
    q0 = Q_HOME if world == "tray_sideways" else Q_TRAY
    centers, sides = BLOCKED if world == "blocked" else FAR
    q_des = q0 + 0.3 * jp.cfg.k_range
    key = jax.random.PRNGKey(0)
    res_j = jp.plan(q0, np.zeros(7), np.zeros(7), q_des,
                    JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 4), key)
    res_t = tp.plan(q0, np.zeros(7), np.zeros(7), q_des, ObstacleSet.from_boxes(centers, sides, 4),
                    k_rand=_starts(key, 1))
    assert bool(res_j.feasible) == bool(res_t.feasible) == (world == "tray_up")
    if world == "tray_up":
        np.testing.assert_allclose(np.asarray(res_j.k), res_t.k.numpy(), rtol=0, atol=1e-6)
        # the grasp block at the returned k, from the port's own build
        prob = tp.build_probs(q0[None], np.zeros((1, 7)), np.zeros((1, 7)),
                              np.zeros((1, 4, 4, 3)), np.zeros((1, 4), bool))
        gc, gr, _ = prob.grasp.slice_with_jac_multi(res_t.k[None, None])
        assert gc.shape == (1, 1, 8, 3) and float((gc + gr[:, None]).max()) <= 1e-6
    else:
        assert np.all(np.isnan(res_t.k.numpy()))


@pytest.mark.parametrize("route", ["cj", "autodiff"])
def test_solve_box_alm_matches_jax(rng, route):
    """A quadratic-plus-quartic cost under nonlinear one-sided constraints,
    three problems at once in the port, one at a time in the JAX package."""
    n, m, B = 5, 4, 3
    Am = rng.normal(size=(m, n))
    Bm = rng.normal(size=(m, n)) * 0.5
    d = rng.uniform(0.2, 0.6, m)
    targets = rng.uniform(-1.5, 1.5, (B, n))
    k0 = rng.uniform(-0.6, 0.6, (B, n))
    iters = dict(outer_iters=5, inner_iters=5)

    def jax_solve(target, start):
        At, Bt, dt, tt = (jnp.asarray(x) for x in (Am, Bm, d, target))

        def f(k):
            return jnp.sum((k - tt) ** 2) + 0.05 * jnp.sum(k**4)

        def c(k):
            return At @ k + 0.2 * (Bt @ k) ** 2 - dt

        def cj(k):
            return c(k), At + 0.4 * (Bt @ k)[:, None] * Bt

        return jax_solve_box_alm(f, c, jnp.asarray(start), cj_fn=cj if route == "cj" else None, **iters)

    At, Bt, dt, tt = (torch.as_tensor(x) for x in (Am, Bm, d, targets))

    def f_t(K):
        return torch.sum((K - tt) ** 2, dim=-1) + 0.05 * torch.sum(K**4, dim=-1)

    def c_t(K):
        return K @ At.T + 0.2 * (K @ Bt.T) ** 2 - dt

    def cj_t(K):
        J = At + 0.4 * (K @ Bt.T)[..., None] * Bt                   # (B, m, n)
        return c_t(K), J.transpose(-1, -2)

    res_t = solve_box_alm(f_t, c_t, torch.as_tensor(k0), cj_fn=cj_t if route == "cj" else None, **iters)
    assert res_t.c is None and res_t.c0 is None and res_t.v_feas is None
    for b in range(B):
        res_j = jax_solve(targets[b], k0[b])
        for field in ("k", "max_violation", "cost", "k_feas", "found_feas"):
            np.testing.assert_allclose(np.asarray(getattr(res_j, field)), getattr(res_t, field)[b].numpy(),
                                       rtol=0, atol=1e-8, err_msg=field)
