"""Parity of the port's low-level control laws with the JAX package, on the
CPU in float64: the four laws of ``control/robust.py`` and the TVLQR gain
schedule and law of ``control/ilqr.py``, unbatched and batched.  Inputs come
from a numpy seed.

Tolerance: rtol 1e-9 on every output (atol 1e-12 for structural zeros).
The TVLQR gains pass through a 50-step Riccati recursion and linear
solves, so they are held to rtol 1e-9 of the largest gain entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.control import ilqr as jax_ilqr
from armour_tpu.control import robust as jax_robust
from armour_tpu.jrs.bezier import bezier_ref as jax_bezier_ref
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.control import ilqr, robust
from armour_tpu_torch.jrs.bezier import bezier_ref
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

JSPEC = jax_kinova_gen3_spec()
SPEC = kinova_gen3_spec()
RTOL, ATOL = 1e-9, 1e-12


def _state(batched, seed, err=1e-3):
    """q, qd near a reference (q_des, qd_des, qdd_des): tracking errors of
    the size the closed loop sees, joint 0 wrapped across pi."""
    rng = np.random.default_rng(seed)
    shape = (3, 7) if batched else (7,)
    q_des, qd_des, qdd_des = (rng.uniform(-1.0, 1.0, shape) for _ in range(3))
    q_des[..., 0] = np.pi - 1e-4           # continuous joint: the error wraps
    q = q_des + rng.uniform(-err, err, shape)
    q[..., 0] += 2.0 * np.pi
    qd = qd_des + rng.uniform(-10 * err, 10 * err, shape)
    return q, qd, q_des, qd_des, qdd_des


def _check(want, got):
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("err", [1e-3, 0.05, 0.0], ids=["small", "large", "zero"])
def test_robust_control_matches_jax(batched, err):
    """Small errors leave the robust term off (h > 0), large ones switch it
    on, zero error takes the r = 0 branch."""
    args = _state(batched, seed=0, err=err)
    want = jax_robust.robust_control(JSPEC, *map(jnp.asarray, args))
    got = robust.robust_control(SPEC, *map(torch.as_tensor, args))
    _check(want, got)
    if err == 0.05:
        assert float(got[2].abs().max()) > 0.0
    swept = dict(mass_scale=(0.9, 1.05), wrap_continuous=False)
    _check(jax_robust.robust_control(JSPEC, *map(jnp.asarray, args), **swept),
           robust.robust_control(SPEC, *map(torch.as_tensor, args), **swept))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_althoff_nominal_pid_match_jax(batched):
    args = _state(batched, seed=1)
    ja, ta = tuple(map(jnp.asarray, args)), tuple(map(torch.as_tensor, args))
    _check(jax_robust.althoff_control(JSPEC, *ja, e_acc=0.3),
           robust.althoff_control(SPEC, *ta, e_acc=0.3))
    _check(jax_robust.nominal_passivity_control(JSPEC, *ja),
           robust.nominal_passivity_control(SPEC, *ta))
    i_err = np.random.default_rng(2).uniform(-1e-3, 1e-3, args[0].shape)
    _check(jax_robust.pid_control(JSPEC, *ja, jnp.asarray(i_err)),
           robust.pid_control(SPEC, *ta, torch.as_tensor(i_err)))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_tvlqr_gain_schedule_and_law_match_jax(batched):
    rng = np.random.default_rng(3)
    shape = (3, 7) if batched else (7,)
    q0, qd0 = rng.uniform(-1.0, 1.0, shape), rng.uniform(-0.3, 0.3, shape)
    k_act = rng.uniform(-1.0, 1.0, shape) * np.pi / 48
    t_move, dt_knot = 0.1, 0.01                                         # 10 knots

    def jax_gains(a, b, c):
        return jax_ilqr.tvlqr_gain_schedule(
            JSPEC, lambda t: jax_bezier_ref(a, b, jnp.zeros(7), c, t, 1.0), t_move, dt_knot)

    gains = jax.jit(jax.vmap(jax_gains) if batched else jax_gains)
    K_j, uff_j = gains(*map(jnp.asarray, (q0, qd0, k_act)))
    q0t, qd0t, kt = map(torch.as_tensor, (q0, qd0, k_act))
    K_t, uff_t = ilqr.tvlqr_gain_schedule(
        SPEC, lambda t: bezier_ref(q0t, qd0t, torch.zeros_like(q0t), kt, t, 1.0),
        t_move, dt_knot, device="cpu")
    assert K_t.shape == shape[:-1] + (10, 7, 14)
    np.testing.assert_allclose(np.asarray(uff_j), uff_t.numpy(), rtol=RTOL, atol=ATOL)
    K_j = np.array(K_j)
    np.testing.assert_allclose(K_j, K_t.numpy(), rtol=RTOL, atol=RTOL * np.abs(K_j).max())

    args = _state(batched, seed=4)
    Kj3 = K_j[..., 3, :, :]
    law = (jax.vmap(lambda *a: jax_ilqr.ilqr_control(JSPEC, *a)) if batched
           else (lambda *a: jax_ilqr.ilqr_control(JSPEC, *a)))
    _check(law(*map(jnp.asarray, args), jnp.asarray(Kj3)),
           ilqr.ilqr_control(SPEC, *map(torch.as_tensor, args), torch.as_tensor(Kj3)))
