"""The planner's exact diagonal derivatives against the generic forward-mode
ones, on the CPU.

The planner's cost is a sum of per-joint terms and its state-limit block is
elementwise over joints, so ``separable_cost_derivatives`` and
``diagonal_jacobian_t`` take their derivatives from one all-ones tangent
where ``cost_derivatives`` and ``jacobian_t`` push one tangent per joint.
The two must agree to the bit (the bit patterns, not only the values; the
generic route writes some of its off-diagonal zeros as -0.0, so zeros are
compared without their sign), in float64 and float32, for the Bezier
planner, ``traj_type="orig"``, grasp constraints and a cost that wraps on
the Kinova's continuous joints; and ``solve_box_alm_multi`` must give the
same bits by both routes.
"""

import numpy as np
import pytest
import torch

from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import GraspConfig, PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.planner.nlp import (
    cost_derivatives,
    diagonal_jacobian_t,
    jacobian_t,
    separable_cost_derivatives,
    solve_box_alm_multi,
)
from armour_tpu_torch.problems import problem_set
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

SETTINGS = ("bernstein", "orig", "grasp", "continuous_wrap")
DTYPES = {"f64": torch.float64, "f32": torch.float32}
Q_TRAY = np.array([0.0, -0.5, 0.0, -2.0, 0.0, -0.6, 0.0])   # end-effector z-axis up


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(setting, dtype, B=2):
    """(planner, built problem, q_des) at T=16 for one setting."""
    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=16, max_obstacles=8)
    kw = {"orig": dict(traj_type="orig"),
          "grasp": dict(grasp=GraspConfig(object_mass=0.2, u_s=0.6, surf_rad=0.03))}.get(setting, {})
    planner = ArmourPlanner(spec, cfg, dtype, device="cpu", **kw)
    if setting == "grasp":
        q0 = Q_TRAY + np.random.default_rng(0).uniform(-0.05, 0.05, (B, 7))
        far = ObstacleSet.from_boxes([[5.0, 5.0, 5.0]], [[0.1, 0.1, 0.1]], cfg.max_obstacles)
        args = (q0, np.zeros((B, 7)), np.zeros((B, 7)), np.tile(far.zonos, (B, 1, 1, 1)),
                np.tile(far.mask, (B, 1)))
        q_des = q0 + 0.3 * cfg.k_range
    else:
        p = problem_set(cfg, B, n_obs=8, seed=0, device="cpu")
        args = (p.q0, p.qd0, p.qdd0, p.zonos, p.masks)
        q_des = p.q_des
        if setting == "continuous_wrap":
            # 4 rad past the plan on every continuous joint: the cost wraps
            q_des = q_des + 4.0 * np.where(spec.continuous_joints, 1.0, 0.0)
    return planner, planner.build_probs(*args), q_des


def _same_bits(a, b, signed_zeros=True):
    """Equal bit patterns; with ``signed_zeros=False``, -0.0 counts as 0.0
    (adding +0.0 changes the bits of nothing else, NaN included)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if not signed_zeros:
        a, b = a + 0.0, b + 0.0
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _starts(planner, B, seed=3):
    S = planner.cfg.nlp_num_starts
    return torch.as_tensor(np.random.default_rng(seed).uniform(-1.0, 1.0, (B, S, 7)), dtype=planner.dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
@pytest.mark.parametrize("setting", SETTINGS)
def test_diagonal_route_equals_the_generic_one_to_the_bit(setting, dtype):
    planner, prob, q_des = _problem(setting, DTYPES[dtype])
    fns = planner.nlp_functions(prob, q_des)
    K = _starts(planner, 2)
    diag, full = diagonal_jacobian_t(fns.limits, K), jacobian_t(fns.limits, K)
    assert diag.shape == (2, planner.cfg.nlp_num_starts, 7, 56)
    (g1, h1), (g0, h0) = separable_cost_derivatives(fns.f, K), cost_derivatives(fns.f, K)
    assert _same_bits(g1, g0)
    assert _same_bits(diag, full, signed_zeros=False) and _same_bits(h1, h0, signed_zeros=False)
    # the nonzero structure the route relies on, seen in the generic result;
    # the diagonal entries equal with their signs
    eye = torch.eye(7, dtype=torch.bool)
    blocks = [x.unflatten(-1, (8, 7)).transpose(-3, -2) for x in (diag, full)]   # (B, S, 8, n, n)
    assert bool((blocks[1][..., ~eye] == 0).all()) and bool((h0[..., ~eye] == 0).all())
    assert _same_bits(blocks[0][..., eye], blocks[1][..., eye])
    assert _same_bits(h1[..., eye], h0[..., eye]) and bool((h0[..., eye] != 0).any())
    if setting == "continuous_wrap":
        # the wrap is taken: the cost does not see a turn of 2 pi on the
        # continuous joints
        turn = 2 * np.pi * np.where(planner.spec.continuous_joints, 1.0, 0.0)
        f_turned = planner.nlp_functions(prob, q_des - turn).f(K)
        torch.testing.assert_close(fns.f(K), f_turned, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
def test_solver_routes_give_the_same_bits(dtype):
    """A T=16 ``solve_box_alm_multi`` (2 outer x 8 inner iterations, 4
    starts, 2 worlds) with the diagonal routes and with the generic ones."""
    planner, prob, q_des = _problem("bernstein", DTYPES[dtype])
    fns = planner.nlp_functions(prob, q_des)
    m_tail = 8 * 7

    def cj_generic(K):
        c, Jt = fns.cj(K)
        return c, torch.cat([Jt[..., :-m_tail], jacobian_t(fns.limits, K)], dim=-1)

    K0 = 0.6 * _starts(planner, 2, seed=5)
    iters = dict(outer_iters=2, inner_iters=8)
    diag = solve_box_alm_multi(fns.f, fns.cj, K0, separable_cost=True, **iters)
    generic = solve_box_alm_multi(fns.f, cj_generic, K0, **iters)
    for name in diag._fields:
        a, b = getattr(diag, name), getattr(generic, name)
        assert (_same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)), name
    assert bool(diag.found_feas.any())
