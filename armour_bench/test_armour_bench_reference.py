"""The plain reference against the program's op-by-op path, both in
float64 on the CPU at a small size (B = 3, T = 32): the reachable sets,
the torque radius, every constraint block and the cost agree."""

import math

import numpy as np
import pytest
import torch

from armour_bench import gen
from armour_bench.reference import check
from armour_bench.reference.config import PlannerConfig as RefConfig
from armour_bench.reference.kinova import kinova_gen3_spec as ref_spec

T = 32


@pytest.fixture(scope="module")
def both():
    from armour_tpu_torch.collision.zonotope import ObstacleSet, buffer_obstacles
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec

    w = gen.worlds(3, 8, math.pi / 48, 40, 11, "cpu")
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    planner = ArmourPlanner(kinova_gen3_spec(), PlannerConfig(num_time_steps=T), dtype=torch.float64,
                            device="cpu")
    prob, link_gens, _, _ = planner.reachable_sets(w["q0"], w["qd0"], w["qdd0"])
    hp = buffer_obstacles(link_gens, ObstacleSet(f64(w["zonos"][:, :8]), torch.as_tensor(w["masks"][:, :8])),
                          slack=0.0, store_bf16=False)
    prob = prob._replace(hp=hp)
    fns = planner.nlp_functions(prob, w["q_des"])
    cfg = RefConfig(num_time_steps=T)
    ref = check.build(ref_spec(), cfg, *(f64(w[k]) for k in ("q0", "qd0", "qdd0", "q_des")),
                      f64(w["zonos"][:, :8]), torch.as_tensor(w["masks"][:, :8]))
    K = torch.as_tensor(np.random.default_rng(5).uniform(-1, 1, (3, 4, 7)))
    return planner, prob, fns, cfg, ref, K


def test_reachable_sets_and_torque_radius_agree(both):
    _, prob, _, _, ref, K = both
    torch.testing.assert_close(ref.t_rad, prob.t_rad, rtol=1e-12, atol=1e-12)
    c_ref = ref.links.slice_with_jac_multi(K)[0]
    c_port = prob.links.slice_with_jac_multi(K)[0]
    torch.testing.assert_close(c_ref, c_port, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ref.hp.dpos, prob.hp.dpos, rtol=1e-12, atol=1e-12)


def test_constraint_blocks_and_cost_agree(both):
    planner, prob, fns, cfg, ref, K = both
    c, _ = fns.cj(K)
    nf, L, O = 7, 7, 8
    m_t = T * nf
    port = {"torque": c[..., : 2 * m_t].amax(-1) - cfg.torque_numeric_slack,
            "collision": c[..., 2 * m_t: 2 * m_t + L * O * T].amax(-1),
            "state": c[..., -8 * nf:].amax(-1)}
    got = check.blocks(ref_spec(), cfg, ref, K)
    for name in port:
        torch.testing.assert_close(got[name], port[name], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(check.cost(ref_spec(), cfg, ref, K), fns.f(K) / cfg.cost_scale,
                               rtol=1e-12, atol=1e-15)


def test_k_unc_minimises_the_cost_over_the_box(both):
    _, _, fns, cfg, ref, K = both
    k = check.k_unconstrained(ref_spec(), cfg, ref)
    assert k.abs().max() <= 1.0
    best = check.cost(ref_spec(), cfg, ref, k[:, None])
    others = check.cost(ref_spec(), cfg, ref, torch.clamp(k[:, None] + 0.05 * K, -1.0, 1.0))
    assert (best <= others + 1e-15).all()


def test_the_judge_passes_the_programs_own_plans_and_fails_altered_ones(both):
    planner, prob, fns, cfg, ref, K = both
    w = gen.worlds(3, 8, math.pi / 48, 40, 11, "cpu")
    ks = gen.starts(3, 2, 7, 11)
    res = planner.plan_batch(w["q0"], w["qd0"], w["qdd0"], w["q_des"], w["zonos"], w["masks"],
                             k_rand=ks, eager=True)
    answers = {"k": res.k, "feasible": res.feasible, "cost": res.cost,
               "max_violation": res.max_violation, "t_rad": res.torque_radius}
    numbers = check.judge(ref_spec(), cfg, w, answers, "cpu")
    assert numbers["unsafe"] == 0 and numbers["missed"] == 0
    assert numbers["t_rad_gap"] < 1e-12 and numbers["cost_gap"] < 1e-9
    assert numbers["viol_gap"] < 1e-9 and numbers["opt_gap"] < 1e-9
    bad = dict(answers, k=torch.where(res.feasible[:, None], torch.clamp(res.k + 0.3, -1, 1), res.k))
    assert check.judge(ref_spec(), cfg, w, bad, "cpu")["cost_gap"] > 1e-6
