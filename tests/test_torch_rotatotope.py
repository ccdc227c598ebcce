"""Parity of the port's self-intersection (rotatotope) block with the JAX
package, on the CPU in float64.

- ``self_intersection_pairs``: the same pairs and the same PRUNED warning
  for the Kinova, planar 2 (none) and planar 6 (10 pairs).
- ``build_self_intersection`` and the values / Jacobian at random k: rtol
  1e-9 (atol 1e-12) at home, at the folded pose and at a random qd0; the
  port's Jacobian against central differences; ties go to the first
  minimum, as ``jnp.argmin``.
- Plans: the Kinova with ``self_intersection=True`` (Bernstein) and
  ``rotatotope_planner`` on planar 6, each against the JAX planner with its
  starts injected through ``k_rand``: ``feasible`` equal, k within 1e-6,
  ``max_violation`` within 1e-9.
- The fused re-verification judges the self-intersection rows at the
  collision threshold, not the state one.

Small sizes: T = 16, S = 2, 4x4 ALM iterations, one JAX planner per robot.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.dynamics.pz_rnea import build_reachable_sets as jax_build_reachable_sets
from armour_tpu.jrs.armtd import make_armtd_jrs as jax_make_armtd_jrs
from armour_tpu.ops.pz import PackedPZ as JaxPackedPZ
from armour_tpu.planner import rotatotope as jrot
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu.robots.planar import planar_arm_spec as jax_planar_arm_spec
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.dynamics.pz_rnea import build_reachable_sets
from armour_tpu_torch.jrs.armtd import make_armtd_jrs
from armour_tpu_torch.ops.pz import PackedPZ
from armour_tpu_torch.planner import rotatotope as trot
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.robots.planar import planar_arm_spec

CFG_KW = dict(num_time_steps=16, max_obstacles=8, nlp_num_starts=2,
              nlp_outer_iters=4, nlp_inner_iters=4)
RTOL, ATOL = 1e-9, 1e-12
Q_HOME = np.array([0.6, -0.1, -0.5, -1.2, -1.6, -1.1, 0.0])
FOLDED = np.array([0.0, 2.7, 0.0, 2.7, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(fn, spec):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pairs = fn(spec)
    return pairs, [str(w.message) for w in caught]


@pytest.mark.parametrize("robot", ["kinova", "planar2", "planar6"])
def test_pairs_match_jax(robot):
    specs = {"kinova": (jax_kinova_gen3_spec, kinova_gen3_spec, ()),
             "planar2": (jax_planar_arm_spec, planar_arm_spec, (2,)),
             "planar6": (jax_planar_arm_spec, planar_arm_spec, (6,))}
    jf, tf, args = specs[robot]
    want, want_msgs = _pairs(jrot.self_intersection_pairs, jf(*args))
    got, got_msgs = _pairs(trot.self_intersection_pairs, tf(*args))
    assert got == want
    assert got_msgs == want_msgs
    assert len(got) == {"kinova": len(want), "planar2": 0, "planar6": 10}[robot]
    if robot == "kinova":
        assert got_msgs and "PRUNED" in got_msgs[0] and "(3, 5)" in got_msgs[0]


def _banks(q0, qd0):
    """The port's bank for B worlds at once, and JAX's for each world."""
    spec, jspec = kinova_gen3_spec(), jax_kinova_gen3_spec()
    cfg = dataclasses.replace(PlannerConfig(**CFG_KW), input_constraints=False)
    jcfg = dataclasses.replace(JaxPlannerConfig(**CFG_KW), input_constraints=False)
    pairs = _pairs(trot.self_intersection_pairs, spec)[0]
    jrs = make_armtd_jrs(spec, cfg, torch.as_tensor(q0), torch.as_tensor(qd0))
    rs = build_reachable_sets(spec, cfg, jrs)
    port = trot.build_self_intersection(rs.link_pz, rs.link_indep_gens, pairs)

    @jax.jit
    def jax_bank(q0_b, qd0_b):
        jrs_b = jax_build_reachable_sets(jspec, jcfg, jax_make_armtd_jrs(jspec, jcfg, q0_b, qd0_b, jnp.float64),
                                         jnp.float64)
        return jrot.build_self_intersection(jrs_b.link_pz, jrs_b.link_indep_gens, pairs)

    return port, [jax_bank(jnp.asarray(q0[b]), jnp.asarray(qd0[b])) for b in range(len(q0))]


@pytest.fixture(scope="module")
def banks():
    q0 = np.stack([np.zeros(7), FOLDED, Q_HOME])
    qd0 = np.zeros((3, 7))
    qd0[2] = np.random.default_rng(0).uniform(-0.5, 0.5, 7)
    return _banks(q0, qd0)


def test_bank_values_and_jacobian_match_jax(banks):
    (diff, R), ref = banks
    K = np.random.default_rng(1).uniform(-1.0, 1.0, (3, 3, 7))
    K[:, 0] = 0.0
    c, J = trot.self_intersection_with_jac_multi(diff, R, torch.as_tensor(K))
    v = trot.self_intersection_values_multi(diff, R, torch.as_tensor(K))
    assert c.shape == v.shape == (3, 3, 16, len(diff.c[0, 0])) and J.shape == (3, 3, 7) + c.shape[2:]
    assert torch.equal(c, v)
    for b, (jdiff, jR) in enumerate(ref):
        assert jdiff.basis == diff.basis
        for name, port in (("c", diff.c[b]), ("G", diff.G[:, b]), ("r", diff.r[b])):
            np.testing.assert_allclose(np.asarray(getattr(jdiff, name)), port.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(np.asarray(jR), R[b].numpy(), rtol=RTOL, atol=ATOL)
        jc, jJ = jrot.self_intersection_with_jac_multi(jdiff, jR, jnp.asarray(K[b]))
        np.testing.assert_allclose(np.asarray(jc), c[b].numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(jJ), J[b].permute(0, 2, 3, 1).numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            np.asarray(jrot.self_intersection_values_multi(jdiff, jR, jnp.asarray(K[b]))),
            v[b].numpy(), rtol=RTOL, atol=ATOL)
    # home separated, folded violated (`tests/test_rotatotope.py`)
    assert float(c[0, 0].max()) <= 0.0 and float(c[1, 0].max()) > 0.05


def test_jacobian_matches_central_differences(banks):
    (diff, R), _ = banks
    K = torch.as_tensor(np.random.default_rng(2).uniform(-0.7, 0.7, (3, 2, 7)))
    _, J = trot.self_intersection_with_jac_multi(diff, R, K)
    eps = 1e-6
    for i in range(7):
        e = torch.zeros(7, dtype=K.dtype)
        e[i] = eps
        fd = (trot.self_intersection_values_multi(diff, R, K + e)
              - trot.self_intersection_values_multi(diff, R, K - e)) / (2 * eps)
        np.testing.assert_allclose(fd.numpy(), J[:, :, i].numpy(), atol=1e-7)


def test_ties_go_to_the_first_minimum():
    """d = 0 at k = 0 and R equal on every axis: all 6 faces tie.  The
    first (the -d_x face) wins, in JAX and in the port: J = -dd_x."""
    rng = np.random.default_rng(3)
    T, P = 2, 3
    G = rng.normal(size=(2, T, P, 3))
    basis = (((0, 1),), ((1, 1),))
    R = np.ones((T, P, 3))
    R[1, 2] = [2.0, 1.5, 1.5]                           # a tie between the y and z faces
    K = np.zeros((1, 2))
    jc, jJ = jrot.self_intersection_with_jac_multi(
        JaxPackedPZ(jnp.zeros((T, P, 3)), jnp.asarray(G), jnp.zeros((T, P, 3)), basis),
        jnp.asarray(R), jnp.asarray(K))
    diff = PackedPZ(torch.zeros((1, T, P, 3), dtype=torch.float64), torch.as_tensor(G)[:, None],
                    torch.zeros((1, T, P, 3), dtype=torch.float64), basis)
    c, J = trot.self_intersection_with_jac_multi(diff, torch.as_tensor(R)[None], torch.as_tensor(K)[None])
    np.testing.assert_array_equal(np.asarray(jc), c[0].numpy())
    np.testing.assert_array_equal(np.asarray(jJ), J[0].permute(0, 2, 3, 1).numpy())
    want = -np.moveaxis(G[..., 0], 0, -1)                # -dd_x, (T, P, n)
    want[1, 2] = -G[:, 1, 2, 1]                          # the first of the y/z tie: -dd_y
    np.testing.assert_array_equal(J[0, 0].permute(1, 2, 0).numpy(), want)


def _jax_starts(key, n):
    return np.asarray(jax.random.uniform(key, (max(CFG_KW["nlp_num_starts"] - 2, 1), n),
                                         jnp.float64, minval=-0.6, maxval=0.6))


@pytest.fixture(scope="module")
def kinova_planners():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**CFG_KW), self_intersection=True),
                ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**CFG_KW), device="cpu",
                              self_intersection=True))


def _assert_plans_equal(res_j, res_t):
    assert bool(res_j.feasible) == bool(res_t.feasible)
    np.testing.assert_allclose(np.asarray(res_j.k), res_t.k.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res_j.max_violation), float(res_t.max_violation),
                               rtol=0, atol=1e-9)


def test_kinova_si_plan_matches_jax(kinova_planners):
    jp, tp = kinova_planners
    assert tp._si_pairs == jp._si_pairs and tp._si_pairs
    # a pose whose self-intersection block is near active (max -0.03 at k = 0)
    q0 = np.array([0.0, 0.5, 0.0, -0.5, 0.0, 0.5, 0.0])
    centers, sides = [[0.5, 0.3, 0.5]], [[0.1, 0.1, 0.1]]
    key = jax.random.PRNGKey(0)
    args = (q0, np.zeros(7), np.zeros(7), q0 + 0.3)
    res_j = jp.plan(*args, JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 8), key)
    res_t = tp.plan(*args, ObstacleSet.from_boxes(centers, sides, 8), k_rand=_jax_starts(key, 7))
    assert bool(res_t.feasible)
    _assert_plans_equal(res_j, res_t)


def test_planar6_rotatotope_plan_matches_jax():
    cfg = dataclasses.replace(PlannerConfig(**CFG_KW), input_constraints=False)
    jcfg = dataclasses.replace(JaxPlannerConfig(**CFG_KW), input_constraints=False)
    jp = jrot.rotatotope_planner(jax_planar_arm_spec(6), jcfg, jnp.float64)
    tp = trot.rotatotope_planner(planar_arm_spec(6), cfg, torch.float64, device="cpu")
    assert tp.traj_type == "orig" and len(tp._si_pairs) == 10
    q0 = np.array([0.3, -0.4, 0.5, -0.3, 0.2, 0.1])
    centers, sides = [[1.5, 1.5, 0.1]], [[0.2, 0.2, 0.2]]
    key = jax.random.PRNGKey(1)
    args = (q0, np.zeros(6), np.zeros(6), q0 + 0.25)
    res_j = jp.plan(*args, JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 8), key)
    res_t = tp.plan(*args, ObstacleSet.from_boxes(centers, sides, 8), k_rand=_jax_starts(key, 6))
    assert bool(res_t.feasible)
    _assert_plans_equal(res_j, res_t)


@pytest.mark.parametrize("level", [5e-5, 2e-4])
def test_fused_verification_gives_si_rows_the_collision_threshold(kinova_planners, level):
    """A self-intersection block made constant in k at ``level``: between
    the state threshold (1e-5) and the collision threshold (1e-4) every
    candidate is accepted, above the collision threshold none is.  Judged
    at the state threshold, the first case would be infeasible."""
    _, tp = kinova_planners
    cfg = tp.cfg
    assert cfg.state_violation_threshold < 5e-5 < cfg.collision_violation_threshold < 2e-4
    far = ObstacleSet.from_boxes([[5.0, 5.0, 5.0]], [[0.1, 0.1, 0.1]], 8)
    zonos = torch.as_tensor(far.zonos)[None]
    masks = torch.as_tensor(far.mask)[None]
    z = torch.zeros((1, 7), dtype=torch.float64)
    q0 = torch.as_tensor(Q_HOME)[None]
    prob = tp.build_probs(q0, z, z, zonos, masks)
    d = prob.si_diff
    flat = PackedPZ(d.c, torch.zeros_like(d.G), d.r, d.basis)     # no k dependence
    v = trot.self_intersection_values_multi(flat, prob.si_rad, z[:, None])
    prob = prob._replace(si_diff=flat, si_rad=prob.si_rad + (level - v.max()))
    res = tp.solve(prob, q0 + 0.2, k_rand=np.zeros((1, 1, 7)))
    assert bool(res.feasible[0]) == (level < cfg.collision_violation_threshold)
    if bool(res.feasible[0]):
        np.testing.assert_allclose(float(res.max_violation[0]), level, rtol=1e-9)
