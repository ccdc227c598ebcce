"""Parity of the port's ARMTD 'orig' mode with the JAX package, on the CPU
in float64: ``armtd_ref``, the JRS PZs of ``make_armtd_jrs`` (centers,
generators, radii), both extrema and their forward-mode Jacobians, and
``ArmourPlanner(traj_type="orig")`` end to end on a free and a blocked
world, and with the self-intersection block.  Inputs come from a numpy
seed; two worlds at once in the port.

Tolerances: rtol 1e-9 (atol 1e-12) for the closed forms and the PZ sets;
plans: ``feasible`` equal and k within 1e-6, the JAX random starts
injected through ``k_rand``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.jrs import armtd as jax_armtd
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.jrs import armtd
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.planner.nlp import jacobian_t
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

CFG_KW = dict(num_time_steps=16, max_obstacles=4, nlp_num_starts=4,
              nlp_outer_iters=8, nlp_inner_iters=8)
Q_HOME = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
RTOL, ATOL = 1e-9, 1e-12


def _states(seed=0):
    """Two worlds; world 1 has joints at rest and joints fast enough that
    every branch of the k_range clamp is taken."""
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(-1.0, 1.0, (2, 7))
    qd0 = rng.uniform(-1.0, 1.0, (2, 7))
    qd0[1, :2] = 0.0
    qd0[1, 2] = 3.5
    return q0, qd0


def test_armtd_ref_matches_jax():
    q0, qd0 = _states()
    ka = np.asarray(jax_armtd.armtd_k_range(jnp.asarray(qd0))) * np.random.default_rng(1).uniform(-1, 1, (2, 7))
    np.testing.assert_allclose(np.asarray(jax_armtd.armtd_k_range(jnp.asarray(qd0))),
                               armtd.armtd_k_range(torch.as_tensor(qd0)).numpy(), rtol=RTOL)
    for t in (0.0, 0.2, 0.5, 0.8, 1.0, 1.3):
        want = jax_armtd.armtd_ref(*map(jnp.asarray, (q0, qd0, ka)), t, 0.5, 1.0)
        got = armtd.armtd_ref(*map(torch.as_tensor, (q0, qd0, ka)), t, 0.5, 1.0)
        for w, g in zip(want, got):
            np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=RTOL, atol=ATOL)
    # a time per world, broadcast against the joints
    t = torch.tensor([[0.3], [0.9]])
    got = armtd.armtd_ref(*map(torch.as_tensor, (q0, qd0, ka)), t, 0.5, 1.0)
    for b in range(2):
        want = jax_armtd.armtd_ref(*map(jnp.asarray, (q0[b], qd0[b], ka[b])), float(t[b, 0]), 0.5, 1.0)
        for w, g in zip(want, got):
            np.testing.assert_allclose(np.asarray(w), g[b].numpy(), rtol=RTOL, atol=ATOL)


def test_make_armtd_jrs_matches_jax():
    q0, qd0 = _states()
    jrs_t = armtd.make_armtd_jrs(kinova_gen3_spec(), PlannerConfig(**CFG_KW),
                                 torch.as_tensor(q0), torch.as_tensor(qd0))
    assert jrs_t.k_range.shape == (2, 7)
    for b in range(2):
        jrs_j = jax_armtd.make_armtd_jrs(jax_kinova_gen3_spec(), JaxPlannerConfig(**CFG_KW), q0[b], qd0[b])
        np.testing.assert_allclose(np.asarray(jrs_j.k_range), jrs_t.k_range[b].numpy(), rtol=RTOL)
        for name in ("cos_q", "sin_q", "R", "R_t"):
            assert len(getattr(jrs_j, name)) == len(getattr(jrs_t, name))
            for jp, tp in zip(getattr(jrs_j, name), getattr(jrs_t, name)):
                assert jp.basis == tp.basis, name
                for field, port in (("c", tp.c[b]), ("G", tp.G[:, b]), ("r", tp.r[b])):
                    np.testing.assert_allclose(np.asarray(getattr(jp, field)), port.numpy(),
                                               rtol=RTOL, atol=ATOL, err_msg=f"{name}.{field}")


def test_armtd_extrema_and_jacobians_match_jax():
    q0, qd0 = _states(seed=2)
    rng = np.random.default_rng(3)
    K = rng.uniform(-1.0, 1.0, (2, 3, 7))            # (B, S, n)
    K[0, 0] = 0.0                                    # k_a = 0: no interior stationary point
    g_k = np.array(jax_armtd.armtd_k_range(jnp.asarray(qd0)))
    q0t, qd0t, gkt = (torch.as_tensor(x)[:, None] for x in (q0, qd0, g_k))

    def pos_t(k):
        return torch.cat(armtd.armtd_position_extrema(q0t, qd0t, gkt, k, 0.5, 1.0), dim=-1)

    def vel_t(k):
        return torch.cat(armtd.armtd_velocity_extrema(qd0t, gkt, k, 0.5), dim=-1)

    Kt = torch.as_tensor(K)
    got = {"pos": pos_t(Kt), "vel": vel_t(Kt),
           "dpos": jacobian_t(pos_t, Kt), "dvel": jacobian_t(vel_t, Kt)}      # (B, S, n, 2n)
    for b in range(2):
        shim = types.SimpleNamespace(q0=jnp.asarray(q0[b]), qd0=jnp.asarray(qd0[b]),
                                     k_range=jnp.asarray(g_k[b]), t_plan=0.5, t_total=1.0)
        pos_j = lambda k: jnp.concatenate(jax_armtd.armtd_position_extrema(shim, k))
        vel_j = lambda k: jnp.concatenate(jax_armtd.armtd_velocity_extrema(shim, k))
        for s in range(3):
            k = jnp.asarray(K[b, s])
            np.testing.assert_allclose(np.asarray(pos_j(k)), got["pos"][b, s].numpy(), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(np.asarray(vel_j(k)), got["vel"][b, s].numpy(), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(np.asarray(jax.jacfwd(pos_j)(k)).T, got["dpos"][b, s].numpy(),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(np.asarray(jax.jacfwd(vel_j)(k)).T, got["dvel"][b, s].numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def planners():
    return (JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**CFG_KW), traj_type="orig"),
            ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**CFG_KW), dtype=torch.float64,
                          device="cpu", traj_type="orig"))


@pytest.mark.parametrize("world", ["free", "blocked"])
def test_plan_orig_matches_jax(planners, world):
    jp, tp = planners
    qd0 = 0.3 * np.ones(7)
    if world == "free":
        centers, sides = [[0.4, 0.2, 0.3]], [[0.1, 0.1, 0.1]]
        g_k = np.asarray(jax_armtd.armtd_k_range(jnp.asarray(qd0)))
        q_des = np.asarray(jax_armtd.armtd_ref(Q_HOME, qd0, 0.7 * g_k, 0.5, 0.5, 1.0)[0])
    else:  # a box engulfing the workspace
        centers, sides = [[0.0, 0.0, 0.6]], [[3.0, 3.0, 1.5]]
        q_des = Q_HOME + 0.05
    key = jax.random.PRNGKey(0)
    k_rand = np.array(jax.random.uniform(key, (2, 7), jnp.float64, minval=-0.6, maxval=0.6))
    res_j = jp.plan(Q_HOME, qd0, np.zeros(7), q_des,
                    JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 4), key)
    res_t = tp.plan(Q_HOME, qd0, np.zeros(7), q_des, ObstacleSet.from_boxes(centers, sides, 4),
                    k_rand=k_rand)
    assert bool(res_j.feasible) == bool(res_t.feasible) == (world == "free")
    if world == "free":
        np.testing.assert_allclose(np.asarray(res_j.k), res_t.k.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(res_j.cost), float(res_t.cost), rtol=0, atol=1e-8)
    else:
        assert np.all(np.isnan(res_t.k.numpy()))
    # no torque constraints and no torque radius in this mode
    assert float(res_t.torque_radius.abs().max()) == 0.0


def test_orig_mode_refuses_what_it_cannot_build():
    spec, cfg = kinova_gen3_spec(), PlannerConfig(**CFG_KW)
    from armour_tpu_torch.config import GraspConfig

    with pytest.raises(ValueError, match="grasp"):
        ArmourPlanner(spec, cfg, device="cpu", traj_type="orig", grasp=GraspConfig())
    with pytest.raises(ValueError, match="traj_type"):
        ArmourPlanner(spec, cfg, device="cpu", traj_type="spline")
    # the self-intersection block builds, and combines with 'orig' (the
    # legacy rotatotope planner): a free world plans with it
    with pytest.warns(UserWarning, match="PRUNED"):
        si = ArmourPlanner(spec, cfg, device="cpu", self_intersection=True)
    assert si._si_pairs and all(j >= i + 2 for i, j in si._si_pairs)
    small = dataclasses.replace(cfg, nlp_num_starts=2, nlp_outer_iters=4, nlp_inner_iters=4)
    orig_si = ArmourPlanner(spec, small, device="cpu", traj_type="orig", self_intersection=si._si_pairs)
    res = orig_si.plan(Q_HOME, np.zeros(7), np.zeros(7), Q_HOME + 0.05,
                       ObstacleSet.from_boxes([[5.0, 5.0, 5.0]], [[0.1, 0.1, 0.1]], 4))
    assert bool(res.feasible) and bool(torch.isfinite(res.k).all())
    assert ArmourPlanner(spec, cfg, device="cpu", self_intersection=[])._si_pairs == []
