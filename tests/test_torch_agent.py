"""Parity of the port's plant simulation with the JAX package, on the CPU
in float64: ``traj_eval`` for both trajectory families, ``rollout_direct``,
and the closed-loop ``rollout`` for the robust and ALTHOFF controllers (the
three baselines are in `test_torch_agent_baselines.py`: the JAX side
compiles each rollout for most of a minute, so each controller runs once
and the cases are spread over two files), two worlds
at once in the port against the JAX package's vmapped single-world rollout.
``SimConfig(plant_dt=5e-3)`` gives 100 RK4 steps; measurement noise is 0
(the two packages draw it from different generators).  Inputs come from a
numpy seed and cross through ``armour_tpu_torch.convert``.

Tolerances: rtol 1e-9 for the closed-form trajectories and the direct mode;
atol 1e-7 for ``q_end``/``qd_end`` and the logged states after 100 steps
(rounding differences pass through the plant's linear solves 400 times),
and 1e-7 of the largest torque for the logged inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.config import SimConfig as JaxSimConfig
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu.sim import agent as jax_agent
from armour_tpu_torch import convert
from armour_tpu_torch.config import SimConfig
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim import agent

JSPEC = jax_kinova_gen3_spec()
SPEC = kinova_gen3_spec()
SIM_KW = dict(t_move=0.5, plant_dt=5e-3, check_dt=0.01)
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are a few worlds wide: one intra-op thread
    runs them as fast as eight, and leaves the cores to the JAX compiles
    and to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _case(traj_type, seed=0):
    """numpy fields of B worlds: start state, trajectory, true parameters."""
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(-1.0, 1.0, (B, 7))
    qd0 = rng.uniform(-0.3, 0.3, (B, 7))
    qdd0 = rng.uniform(-0.3, 0.3, (B, 7))
    # 'orig' takes an acceleration k_a = g_k * k, 'bernstein' a position offset
    k_act = rng.uniform(-1.0, 1.0, (B, 7)) * (np.pi / 24 if traj_type == "orig" else np.pi / 48)
    traj = (q0, qd0, qdd0, k_act, np.array([0.0, 0.5]))        # world 1 is braking
    true = (rng.uniform(0.97, 1.03, (B, 7)), rng.uniform(0.97, 1.03, (B, 7)))
    return q0, qd0, traj, true


@pytest.mark.parametrize("traj_type", ["bernstein", "orig"])
def test_traj_eval_matches_jax(traj_type):
    _, _, traj, _ = _case(traj_type)
    p_t = convert.traj_params_from_numpy(*traj, device="cpu")
    for t in (0.0, 0.13, 0.5, 0.77, 1.4):
        want = jax.vmap(lambda p: jax_agent.traj_eval(p, t, 1.0, traj_type, 0.5))(
            jax_agent.TrajParams(*map(jnp.asarray, traj)))
        got = agent.traj_eval(p_t, t, 1.0, traj_type, 0.5)
        for w, g in zip(want, got):
            np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-9, atol=1e-12)
    # one world, unbatched fields
    one = convert.traj_params_from_numpy(*(x[1] for x in traj), device="cpu")
    for a, b in zip(agent.traj_eval(one, 0.2, 1.0, traj_type, 0.5), agent.traj_eval(p_t, 0.2, 1.0, traj_type, 0.5)):
        assert torch.equal(a, b[1])


@pytest.mark.parametrize("traj_type", ["bernstein", "orig"])
def test_rollout_direct_matches_jax(traj_type):
    q0, qd0, traj, true = _case(traj_type, seed=1)
    want = jax.vmap(lambda q, qd, p, tp: jax_agent.rollout_direct(
        JSPEC, JaxSimConfig(**SIM_KW), q, qd, p, tp, 1.0, traj_type))(
        jnp.asarray(q0), jnp.asarray(qd0), jax_agent.TrajParams(*map(jnp.asarray, traj)),
        jax_agent.TrueParams(*map(jnp.asarray, true)))
    got = agent.rollout_direct(SPEC, SimConfig(**SIM_KW), q0, qd0,
                               convert.traj_params_from_numpy(*traj, device="cpu"),
                               convert.true_params_from_numpy(*true, device="cpu"),
                               1.0, traj_type, device="cpu")
    np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(want[1]), got[1].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(want[2].t[0]), got[2].t.numpy(), rtol=1e-12, atol=0)
    for name in ("q", "qd", "q_ref", "qd_ref", "u"):
        np.testing.assert_allclose(np.asarray(getattr(want[2], name)), getattr(got[2], name).numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def check_rollout_matches_jax(controller, traj_type):
    """``rollout`` of both packages on the same two worlds, 100 steps."""
    q0, qd0, traj, true = _case(traj_type, seed=2)
    q0 = q0 + 1e-3                      # start off the reference
    jax_roll = jax.jit(jax.vmap(lambda q, qd, p, tp: jax_agent.rollout(
        JSPEC, JaxSimConfig(**SIM_KW), q, qd, p, tp, 1.0, controller=controller,
        traj_type=traj_type)))
    want_q, want_qd, want_log = jax_roll(
        jnp.asarray(q0), jnp.asarray(qd0), jax_agent.TrajParams(*map(jnp.asarray, traj)),
        jax_agent.TrueParams(*map(jnp.asarray, true)))
    got_q, got_qd, got_log = agent.rollout(
        SPEC, SimConfig(**SIM_KW), q0, qd0, convert.traj_params_from_numpy(*traj, device="cpu"),
        convert.true_params_from_numpy(*true, device="cpu"), 1.0, controller=controller,
        traj_type=traj_type, device="cpu")
    np.testing.assert_allclose(np.asarray(want_q), got_q.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(want_qd), got_qd.numpy(), rtol=0, atol=1e-7)
    # the log is subsampled to check_dt: every second step of the 100
    assert got_log.q.shape == (B, 50, 7) and got_log.t.shape == (50,)
    np.testing.assert_allclose(np.asarray(want_log.t[0]), got_log.t.numpy(), rtol=1e-12, atol=0)
    for name in ("q", "qd", "q_ref", "qd_ref"):
        np.testing.assert_allclose(np.asarray(getattr(want_log, name)), getattr(got_log, name).numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)
    u_j = np.asarray(want_log.u)
    np.testing.assert_allclose(u_j, got_log.u.numpy(), rtol=0, atol=1e-7 * np.abs(u_j).max())
    # one world alone gives the batch's row
    _, _, one_log = agent.rollout(
        SPEC, SimConfig(**SIM_KW), q0[1], qd0[1],
        convert.traj_params_from_numpy(*(x[1] for x in traj), device="cpu"),
        convert.true_params_from_numpy(*(x[1] for x in true), device="cpu"), 1.0,
        controller=controller, traj_type=traj_type, device="cpu")
    np.testing.assert_allclose(one_log.q.numpy(), got_log.q[1].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("controller", ["robust", "althoff"])
def test_rollout_matches_jax(controller):
    check_rollout_matches_jax(controller, "bernstein")


def test_rollout_noise_comes_from_the_given_generator():
    """Noise 0 unless a generator (or a noise tensor) is given; the same
    seed gives the same rollout."""
    q0, qd0, traj, true = _case("bernstein", seed=3)
    sim = SimConfig(t_move=0.05, plant_dt=5e-3, measurement_noise_std=1e-4)
    args = (SPEC, sim, q0, qd0, convert.traj_params_from_numpy(*traj, device="cpu"),
            convert.true_params_from_numpy(*true, device="cpu"))
    quiet = agent.rollout(*args, device="cpu")[0]
    a = agent.rollout(*args, generator=torch.Generator().manual_seed(5), device="cpu")[0]
    b = agent.rollout(*args, generator=torch.Generator().manual_seed(5), device="cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, quiet)
    zero = agent.rollout(*args, noise=np.zeros((10, 2, B, 7)), device="cpu")[0]
    assert torch.equal(zero, quiet)
    with pytest.raises(ValueError, match="unknown controller"):
        agent.rollout(*args, controller="bang-bang", device="cpu")
