"""Parity of the port's numeric dynamics with the JAX package, on the CPU in
float64: ``dynamics/rnea.py`` (point and interval RNEA, mass matrix, bias
forces) and every function of ``dynamics/utility.py``, unbatched (nf,) and
batched (B, nf).  Inputs come from a numpy seed.

Tolerance: rtol 1e-9 (atol 1e-12 for entries that are zero by structure):
the two packages take the same sums in a different order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch.dynamics import rnea as tr
from armour_tpu_torch.dynamics import utility as tu
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

# the JAX subpackage re-exports functions under its modules' names
jr = importlib.import_module("armour_tpu.dynamics.rnea")
ju = importlib.import_module("armour_tpu.dynamics.utility")
JSPEC = jax_kinova_gen3_spec()
SPEC = kinova_gen3_spec()
RTOL, ATOL = 1e-9, 1e-12


def _inputs(batched, seed=0):
    rng = np.random.default_rng(seed)
    shape = (3, 7) if batched else (7,)
    return tuple(rng.uniform(-1.0, 1.0, shape) for _ in range(4))      # q, qd, qd_aux, qdd


def _close(jax_value, torch_value):
    np.testing.assert_allclose(np.asarray(jax_value), torch_value.numpy(), rtol=RTOL, atol=ATOL)


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("gravity", [True, False])
@pytest.mark.parametrize("armature", [True, False])
def test_rnea_matches_jax(batched, gravity, armature):
    args = _inputs(batched)
    _close(jr.rnea(JSPEC, *map(jnp.asarray, args), use_gravity=gravity, use_armature=armature),
           tr.rnea(SPEC, *_t(*args), use_gravity=gravity, use_armature=armature))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_rnea_with_true_params_matches_jax(batched):
    """Overridden inertial parameters, as the plant uses them; in the port
    they may differ per world."""
    args = _inputs(batched)
    rng = np.random.default_rng(1)
    scale = rng.uniform(0.97, 1.03, (2, 7))
    mass, inertia = SPEC.mass * scale[0], SPEC.inertia * scale[1][:, None, None]
    want = jr.rnea(JSPEC, *map(jnp.asarray, args), mass=jnp.asarray(mass), inertia=jnp.asarray(inertia))
    _close(want, tr.rnea(SPEC, *_t(*args), mass=mass, inertia=inertia))
    if batched:  # the same parameters written out per world
        per_world = tr.rnea(SPEC, *_t(*args), mass=np.tile(mass, (3, 1)),
                            inertia=np.tile(inertia, (3, 1, 1, 1)))
        _close(want, per_world)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("mass_scale", [None, (0.9, 1.05)], ids=["spec", "swept"])
def test_rnea_interval_matches_jax(batched, mass_scale):
    args = _inputs(batched, seed=2)
    for gravity in (True, False):
        want = jr.rnea_interval(JSPEC, *map(jnp.asarray, args), use_gravity=gravity, mass_scale=mass_scale)
        got = tr.rnea_interval(SPEC, *_t(*args), use_gravity=gravity, mass_scale=mass_scale)
        _close(want.lo, got.lo)
        _close(want.hi, got.hi)
        u_nom, du = tr.rnea_with_bound(SPEC, *_t(*args), use_gravity=gravity, mass_scale=mass_scale)
        assert torch.equal(u_nom - du, got.lo) and torch.equal(u_nom + du, got.hi)
        assert torch.equal(u_nom, tr.rnea(SPEC, *_t(*args), use_gravity=gravity))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_mass_matrix_and_bias_forces_match_jax(batched):
    q, qd, _, _ = _inputs(batched, seed=3)
    for arm in (True, False):
        M = tr.mass_matrix(SPEC, torch.as_tensor(q), include_armature=arm)
        _close(jr.mass_matrix(JSPEC, jnp.asarray(q), include_armature=arm), M)
    assert M.shape == q.shape + (7,)
    np.testing.assert_allclose(M.numpy(), np.swapaxes(M.numpy(), -1, -2), rtol=0, atol=1e-12)
    _close(jr.bias_forces(JSPEC, jnp.asarray(q), jnp.asarray(qd)),
           tr.bias_forces(SPEC, *_t(q, qd)))


def test_shared_rotations_and_constants_change_nothing():
    """The hoisted joint rotations and link constants give the same bits as
    the plain calls."""
    q, qd, qa, qdd = _t(*_inputs(True, seed=4))
    consts = tr.link_constants(SPEC, q)
    R = tr.joint_rotations(SPEC, q)
    assert torch.equal(tr.rnea(SPEC, q, qd, qa, qdd), tr.rnea(SPEC, q, qd, qa, qdd, consts=consts, R=R))
    a, b = tr.rnea_interval(SPEC, q, qd, qa, qdd), tr.rnea_interval(SPEC, q, qd, qa, qdd, consts=consts, R=R)
    assert torch.equal(a.lo, b.lo) and torch.equal(a.hi, b.hi)
    assert torch.equal(tr.mass_matrix(SPEC, q), tr.mass_matrix(SPEC, q, consts=consts, R=R))
    # gravity switched per row: rows 0..6 the mass-matrix columns, row 7 the bias
    rows = torch.zeros(8, 1, dtype=q.dtype)
    rows[7] = 1.0
    qdd8 = torch.cat([torch.eye(7, dtype=q.dtype), torch.zeros(1, 7, dtype=q.dtype)])[:, None]
    out = tr.rnea(SPEC, q, rows[..., None] * qd, rows[..., None] * qd, qdd8, use_gravity=rows,
                  consts=consts, R=R)
    np.testing.assert_allclose(out[:7].movedim(0, -1).numpy(), tr.mass_matrix(SPEC, q).numpy(),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(out[7].numpy(), tr.bias_forces(SPEC, q, qd).numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_utility_matches_jax(batched):
    q, qd, _, qdd = _inputs(batched, seed=5)
    qj, qdj, qddj = map(jnp.asarray, (q, qd, qdd))
    qt, qdt, qddt = _t(q, qd, qdd)
    vm = jax.vmap if batched else (lambda f: f)

    for want, got in zip(vm(lambda x: ju.ee_pose(JSPEC, x))(qj), tu.ee_pose(SPEC, qt)):
        _close(want, got)
    _close(vm(lambda x: ju.ee_jacobian(JSPEC, x))(qj), tu.ee_jacobian(SPEC, qt))
    _close(ju.gravity_torque(JSPEC, qj), tu.gravity_torque(SPEC, qt))
    _close(ju.coriolis_torque(JSPEC, qj, qdj), tu.coriolis_torque(SPEC, qt, qdt))
    u = np.random.default_rng(6).uniform(-5.0, 5.0, q.shape)
    _close(vm(lambda a, b, c: ju.forward_dynamics(JSPEC, a, b, c))(qj, qdj, jnp.asarray(u)),
           tu.forward_dynamics(SPEC, qt, qdt, torch.as_tensor(u)))

    # trajectories: N = 5 knots
    rng = np.random.default_rng(7)
    N = 5
    tshape = q.shape[:-1] + (N, 7)
    qs, qds, qdds, us = (rng.uniform(-1.0, 1.0, tshape) for _ in range(4))
    _close(ju.inverse_dynamics_trajectory(JSPEC, *map(jnp.asarray, (qs, qds, qdds))),
           tu.inverse_dynamics_trajectory(SPEC, *_t(qs, qds, qdds)))
    roll = vm(lambda a, b, c: ju.forward_dynamics_trajectory(JSPEC, a, b, c, 0.01))
    want_q, want_qd = roll(qj, qdj, jnp.asarray(us))
    got_q, got_qd = tu.forward_dynamics_trajectory(SPEC, qt, qdt, torch.as_tensor(us), 0.01)
    assert got_q.shape == q.shape[:-1] + (N + 1, 7)
    _close(want_q, got_q)
    _close(want_qd, got_qd)
