"""Parity of the port's NLP solver and batched planner with the JAX
package, on the CPU in float64 (split from `tests/test_torch_planner.py`,
whose helpers it shares, along its module-scoped JAX planner: neither test
here uses it).

- ``solve_box_alm_multi`` on one small synthetic problem (the same cost,
  constraints and starts in both packages): every returned field at
  atol 1e-8.
- ``plan_batch`` over 3 worlds, one with far obstacles that the
  whole-FRS culling must drop: the same post-culling bucket and bank as
  the JAX build, and each row equal to the single-world ``plan``.

The JAX side runs its portable XLA path on the CPU, never Pallas.
"""

import jax.numpy as jnp
import numpy as np
import torch

from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.planner.nlp import solve_box_alm_multi as jax_solve_box_alm_multi
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.planner.nlp import solve_box_alm_multi
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from test_torch_planner import CFG_KW, N_RAND, Q_HOME, _home_frames, one_torch_thread  # noqa: F401


def test_solve_box_alm_multi_matches_jax(rng):
    """A quadratic-plus-quartic cost under nonlinear one-sided constraints,
    S=3 starts, 2 worlds; every ALMResult field at atol 1e-8."""
    n, m, S = 7, 6, 3
    Am = rng.normal(size=(m, n))
    Bm = rng.normal(size=(m, n)) * 0.5
    d = rng.uniform(0.2, 0.6, m)
    targets = rng.uniform(-1.5, 1.5, (2, n))
    K0 = np.concatenate([np.zeros((2, 1, n)), rng.uniform(-0.6, 0.6, (2, S - 1, n))], axis=1)

    def jax_solve(target, k0):
        At, Bt, dt, tt = (jnp.asarray(x) for x in (Am, Bm, d, target))

        def f(k):
            return jnp.sum((k - tt) ** 2) + 0.05 * jnp.sum(k**4)

        def cj(K):
            z = K @ Bt.T
            return K @ At.T + 0.2 * z**2 - dt, At[None] + 0.4 * z[..., None] * Bt[None]

        return jax_solve_box_alm_multi(f, cj, jnp.asarray(k0))

    At, Bt, dt = (torch.as_tensor(x) for x in (Am, Bm, d))
    tt = torch.as_tensor(targets)[:, None]

    def f_t(K):
        return torch.sum((K - tt) ** 2, dim=-1) + 0.05 * torch.sum(K**4, dim=-1)

    def cj_t(K):
        z = K @ Bt.T
        J = At[None, None] + 0.4 * z[..., None] * Bt[None, None]   # (B, S, m, n)
        return K @ At.T + 0.2 * z**2 - dt, J.transpose(-1, -2)

    res_t = solve_box_alm_multi(f_t, cj_t, torch.as_tensor(K0))
    for b in range(2):
        res_j = jax_solve(targets[b], K0[b])
        for field in res_j._fields:
            np.testing.assert_allclose(np.asarray(getattr(res_j, field)),
                                       getattr(res_t, field)[b].numpy(),
                                       rtol=0, atol=1e-8, err_msg=field)


def test_plan_batch_culls_far_obstacles_like_jax():
    """16 obstacle slots; world 0 has 9 live obstacles, 7 of them far
    outside the arm's reach (whole-FRS culling drops them), so the batch
    solves at bucket 8 instead of 16, as the JAX build does."""
    kw = dict(CFG_KW, max_obstacles=16)
    jp = JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**kw))
    tp = ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**kw), dtype=torch.float64, device="cpu")
    frames = _home_frames()
    # within reach of the arm: 20-30 cm from two of its joint frames
    near = [frames[-1] + [0.0, 0.0, 0.2], frames[4] + [0.0, 0.25, 0.0]]
    far = [[5.0, 5.0, 5.0], [-5.0, -5.0, 1.0], [5.0, -5.0, 2.0],
           [-5.0, 5.0, 3.0], [0.0, 6.0, 0.5], [6.0, 0.0, 0.5], [0.0, -6.0, 0.5]]
    sides = [[0.1, 0.1, 0.1]] * 9
    # far obstacles first, so culling must also compact the kept ones
    worlds = [ObstacleSet.from_boxes(far + near, sides, 16),
              ObstacleSet.from_boxes(near[:2], sides[:2], 16),
              ObstacleSet.from_boxes(np.zeros((0, 3)), np.zeros((0, 3)), 16)]
    zonos = np.stack([w.zonos for w in worlds])
    masks = np.stack([w.mask for w in worlds])
    B = 3
    q0 = np.tile(Q_HOME, (B, 1)) + np.random.default_rng(1).uniform(-0.05, 0.05, (B, 7))
    zeros = np.zeros((B, 7))
    q_des = q0 + 0.5 * tp.cfg.k_range

    prob_j = jp.build_probs(jnp.asarray(q0), jnp.asarray(zeros), jnp.asarray(zeros),
                            jnp.asarray(zonos), jnp.asarray(masks))
    prob_t = tp.build_probs(q0, zeros, zeros, zonos, masks)
    assert prob_t.hp.dpos.shape[-2] == prob_j.hp.dpos.shape[-2] == 8
    np.testing.assert_array_equal(np.asarray(prob_j.hp.obs_mask), prob_t.hp.obs_mask.numpy())
    np.testing.assert_array_equal(prob_t.hp.obs_mask[0].numpy(), [True] * 2 + [False] * 6)
    for name in ("A", "dpos", "dneg"):
        np.testing.assert_allclose(np.asarray(getattr(prob_j.hp, name)),
                                   getattr(prob_t.hp, name).numpy(), rtol=0, atol=1e-12)

    k_rand = np.random.default_rng(2).uniform(-0.6, 0.6, (B, N_RAND, 7))
    res = tp.plan_batch(q0, zeros, zeros, q_des, zonos, masks, k_rand=k_rand)
    assert res.feasible.all()
    for b in range(B):
        single = tp.plan(q0[b], zeros[b], zeros[b], q_des[b], worlds[b], k_rand=k_rand[b])
        assert bool(single.feasible)
        np.testing.assert_allclose(res.k[b].numpy(), single.k.numpy(), rtol=0, atol=1e-6)
