"""Parity of the port's recorded episode with the JAX package, on the CPU
in float64: ``run_recorded_episode`` for 2 iterations at T=16 with
``SimConfig(plant_dt=5e-3)`` on the first assets world cut to 7 obstacles,
the port fed the JAX package's draws (true parameters and random starts);
then the ``save`` / ``load_recording`` and ``export_hardware_csv`` round
trips.

Tolerances: ``feasible`` and the episode flags equal; the plan's k within
1e-9 and the planning states within 1e-9; the logged motion within 1e-7
(as `test_torch_agent.py`: rounding passes through the plant's linear
solves 400 times per move); saved arrays as recorded, the CSV to its six
printed digits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.config import SimConfig as JaxSimConfig
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu.sim import recording as jax_rec
from armour_tpu.sim.world import World as JaxWorld
from armour_tpu_torch.collision.zonotope import ObstacleSet
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import recording
from armour_tpu_torch.sim.harness import Draws, TrueParams
from armour_tpu_torch.sim.world import World
from test_torch_harness import one_torch_thread, two_worlds  # noqa: F401 (a fixture)

SPEC, JSPEC = kinova_gen3_spec(), jax_kinova_gen3_spec()
PCFG = dict(num_time_steps=16)
SCFG = dict(plant_dt=5e-3, max_iterations=2)


def jax_recorded_draws(key, n_iters, n_starts):
    """The JAX recorded episode's key stream (`recording.py:116-122, 150`)
    while no replan stalls."""
    f64 = jnp.float64
    lo, hi = JaxSimConfig().uncertain_mass_range
    kt, key = jax.random.split(key)
    k1, k2 = jax.random.split(kt)
    tp = TrueParams(*(torch.as_tensor(np.array(jax.random.uniform(k, (7,), f64, lo, hi)))
                      for k in (k1, k2)))
    out = []
    for _ in range(n_iters):
        key, ki = jax.random.split(key)
        k_rand = jax.random.uniform(ki, (max(n_starts - 2, 1), 7), f64, -0.6, 0.6)
        out.append(Draws(torch.as_tensor(np.array(k_rand))[None], torch.zeros((1, 32, 7))))
    return tp, out


@pytest.fixture(scope="module")
def episodes():
    starts, goals, zonos, masks = two_worlds()
    jworld = JaxWorld(jnp.asarray(starts[0]), jnp.asarray(goals[0]),
                      JaxObstacleSet(jnp.asarray(zonos[0]), jnp.asarray(masks[0])))
    want = jax_rec.run_recorded_episode(JSPEC, JaxPlannerConfig(**PCFG), JaxSimConfig(**SCFG), jworld)
    tp, draws = jax_recorded_draws(jax.random.PRNGKey(0), SCFG["max_iterations"],
                                   PlannerConfig().nlp_num_starts)
    world = World(torch.as_tensor(starts[0]), torch.as_tensor(goals[0]),
                  ObstacleSet(torch.as_tensor(zonos[0]), torch.as_tensor(masks[0])))
    got = recording.run_recorded_episode(SPEC, PlannerConfig(**PCFG), SimConfig(**SCFG), world,
                                         device="cpu", true_params=tp, draws=lambda i: draws[i])
    return want, got


def test_run_recorded_episode_matches_jax(episodes):
    want, got = episodes
    assert len(got.records) == len(want.records) == 2
    for name in ("goal_reached", "collision", "stopped"):
        assert getattr(got, name) == getattr(want, name), name
    for r_t, r_j in zip(got.records, want.records):
        assert r_t.feasible == r_j.feasible
        for name, atol in (("k", 1e-9), ("q_des", 1e-9), ("q0p", 1e-9), ("qd0p", 1e-9),
                           ("qdd0p", 1e-9), ("torque_radius", 1e-9), ("t", 1e-12), ("q", 1e-7),
                           ("qd", 1e-7), ("q_ref", 1e-7), ("qd_ref", 1e-7)):
            np.testing.assert_allclose(getattr(r_t, name), np.asarray(getattr(r_j, name)),
                                       rtol=0, atol=atol, err_msg=name)
        u_j = np.asarray(r_j.u)
        np.testing.assert_allclose(r_t.u, u_j, rtol=0, atol=1e-7 * np.abs(u_j).max())
    assert any(r.feasible for r in got.records)


def test_save_load_and_export_round_trips(episodes, tmp_path):
    want, got = episodes
    got.save(tmp_path / "port.npz")
    want.save(tmp_path / "jax.npz")
    a = recording.load_recording(tmp_path / "port.npz")
    b = jax_rec.load_recording(tmp_path / "jax.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k].astype(float), b[k].astype(float), rtol=0, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(a["q"], np.concatenate([r.q for r in got.records]))
    np.testing.assert_array_equal(a["k"], np.stack([r.k for r in got.records]))
    got.export_hardware_csv(tmp_path / "port.csv")
    want.export_hardware_csv(tmp_path / "jax.csv")
    rows_t = np.loadtxt(tmp_path / "port.csv", delimiter=",")
    rows_j = np.loadtxt(tmp_path / "jax.csv", delimiter=",")
    assert rows_t.shape == rows_j.shape == (2 * got.records[0].t.shape[0], 22)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-5, atol=1e-6)
    # an empty recording saves too
    empty = recording.EpisodeRecording(got.world, [], False, False, False)
    empty.save(tmp_path / "empty.npz")
    assert recording.load_recording(tmp_path / "empty.npz")["q"].shape == (0, 7)
