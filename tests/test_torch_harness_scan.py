"""Parity of the port's episode program (``EpisodeRunner.run_batch``, an
eager loop over iterations) with the JAX package's (one ``lax.scan`` over
iterations, vmapped over worlds), on the CPU in float64 at T=16,
``SimConfig(plant_dt=5e-3, max_iterations=4)``, capacity 8, in the
``"direct"`` move mode (the reference trajectory executed exactly:
`test_torch_harness.py` holds the plant's mode to the JAX package through
the battery driver, and the JAX scan compiles for half as long without the
RK4 loop), the port fed the JAX package's draws.  World 0 is the first assets world cut to 7
obstacles; world 1 holds a 1 cm box 1 cm off a link's bounding box at its
start: no collision, every plan infeasible, no motion, so the world takes
the clearance waypoint at its fourth replan and stops after it.

Held equal: every flag, ``iterations`` and ``n_feasible_plans``.  The JAX
scan compiles for over a minute, so it has this file to itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.config import SimConfig as JaxSimConfig
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu.sim import harness as jax_harness
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import harness
from test_torch_harness import FLAGS, one_torch_thread, two_worlds  # noqa: F401 (a fixture)

SPEC, JSPEC = kinova_gen3_spec(), jax_kinova_gen3_spec()
PCFG = dict(num_time_steps=16, max_obstacles=8)
SCFG = dict(plant_dt=5e-3, max_iterations=4)


def scan_worlds():
    starts, goals, zonos, masks = two_worlds()
    link = 3
    Rw, pw = forward_kinematics(SPEC, torch.as_tensor(starts[1]))
    center = Rw[link] @ torch.as_tensor(SPEC.link_zono_center[link]) + pw[link]
    center = center + Rw[link][:, 0] * (SPEC.link_zono_gen[link][0] + 0.01 + 0.005)
    near = ObstacleSet.from_boxes(center.numpy()[None], [[0.01, 0.01, 0.01]], 8)
    zonos, masks = zonos[:, :8].copy(), masks[:, :8].copy()
    zonos[1], masks[1] = near.zonos, near.mask
    return starts, goals, zonos, masks


def jax_scan_draws(keys, n_iters, n_starts):
    """The JAX episode program's key stream (`harness.py:133-139, 169`)."""
    f64 = jnp.float64
    lo, hi = JaxSimConfig().uncertain_mass_range
    kt_key = jax.vmap(jax.random.split)(keys)
    k12 = jax.vmap(jax.random.split)(kt_key[:, 0])
    tp = [np.array(jax.vmap(lambda k: jax.random.uniform(k, (7,), f64, lo, hi))(k12[:, j]))
          for j in (0, 1)]
    key = kt_key[:, 1]
    out = []
    for _ in range(n_iters):
        k3 = jax.vmap(lambda k: jax.random.split(k, 3))(key)
        k_rand = jax.vmap(lambda k: jax.random.uniform(k, (max(n_starts - 2, 1), 7), f64,
                                                       -0.6, 0.6))(k3[:, 0])
        clear = jax.vmap(lambda k: jax.random.normal(k, (32, 7), f64))(k3[:, 1])
        key = k3[:, 2]
        out.append(harness.Draws(torch.as_tensor(np.array(k_rand)), torch.as_tensor(np.array(clear))))
    return harness.TrueParams(*(torch.as_tensor(x) for x in tp)), out


def test_run_batch_matches_jax_scan(monkeypatch):
    starts, goals, zonos, masks = scan_worlds()
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jrunner = jax_harness.EpisodeRunner(JSPEC, JaxPlannerConfig(**PCFG), JaxSimConfig(**SCFG),
                                        move_mode="direct")
    want = jrunner.run_batch(jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(zonos),
                             jnp.asarray(masks), keys)
    tp, draws = jax_scan_draws(keys, SCFG["max_iterations"], PlannerConfig().nlp_num_starts)
    clear_calls = []
    original = harness.clearance_waypoint

    def counted(*args, **kw):
        clear_calls.append(1)
        return original(*args, **kw)

    monkeypatch.setattr(harness, "clearance_waypoint", counted)
    runner = harness.EpisodeRunner(SPEC, PlannerConfig(**PCFG), SimConfig(**SCFG), device="cpu",
                                   move_mode="direct")
    got = runner.run_batch(starts, goals, zonos, masks, true_params=tp, draws=lambda i: draws[i])
    for name in FLAGS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.jl_overshoot is None
    # what world 1 was built to exercise: stopped safely after the clearance
    # waypoint, without a collision
    assert got.stopped.tolist() == [False, True] and not bool(got.collision.any())
    assert got.n_feasible_plans.tolist()[1] == 0 and clear_calls == [1]
