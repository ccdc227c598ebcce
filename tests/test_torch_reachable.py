"""Parity of the port's Bezier JRS and PZ-FK/RNEA reachable sets with the
JAX package and with the committed golden fixture, on the CPU in float64.

Inputs: `tests/test_golden.py`'s Q0/QD0/QDD0 at T=16, sliced at its
K_VALUES.  Tolerance: rtol 1e-9 / atol 1e-10, the golden fixture's own.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.dynamics.pz_rnea import build_reachable_sets as jax_build_reachable_sets
from armour_tpu.jrs.bezier import make_bezier_jrs as jax_make_bezier_jrs
from armour_tpu.ops.pz import pack_pzs as jax_pack_pzs
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch import convert
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.dynamics.pz_rnea import build_reachable_sets
from armour_tpu_torch.jrs.bezier import make_bezier_jrs
from armour_tpu_torch.ops.pz import pack_pzs
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from test_golden import K_VALUES, Q0, QD0, QDD0

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_slices.npz")
RTOL, ATOL = 1e-9, 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are a few worlds wide: one intra-op thread
    runs them as fast as eight, and leaves the cores to the JAX compiles
    and to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def port_sets():
    """Reachable sets of the port for the golden start state (B = 1)."""
    spec, cfg = kinova_gen3_spec(), PlannerConfig(num_time_steps=16)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64)[None]

    jrs = make_bezier_jrs(spec, cfg, t(Q0), t(QD0), t(QDD0))
    rs = build_reachable_sets(spec, cfg, jrs)
    links = pack_pzs(rs.link_pz, axis=2)
    u = pack_pzs(rs.u_nom, axis=-1)
    K = t(K_VALUES)
    link_c, _, _ = links.slice_with_jac_multi(K)
    u_c, u_r, _ = u.slice_with_jac_multi(K)
    return jrs, rs, link_c[0].numpy(), u_c[0].numpy(), u_r[0].numpy()


def test_reachable_sets_match_golden_fixture(port_sets):
    _, rs, link_c, u_c, u_r = port_sets
    with np.load(FIXTURE) as z:
        for i in range(len(K_VALUES)):
            np.testing.assert_allclose(link_c[i], z[f"link_c_{i}"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(u_c[i], z[f"u_c_{i}"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(u_r, z[f"u_r_{i}"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rs.torque_radius[0].numpy(), z["torque_radius"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rs.link_indep_gens[0].numpy(), z["link_gens"], rtol=RTOL, atol=ATOL)


def test_reachable_sets_match_jax(port_sets):
    """JRS PZs and packed reachable-set tensors against the JAX package:
    the same monomial bases and coefficients."""
    jrs, rs, _, _, _ = port_sets
    spec, cfg = jax_kinova_gen3_spec(), JaxPlannerConfig(num_time_steps=16)
    jjrs = jax_make_bezier_jrs(spec, cfg, Q0, QD0, QDD0)
    jrs_ = jax_build_reachable_sets(spec, cfg, jjrs)
    for name in ("cos_q", "sin_q", "qd_des", "qda_des", "qdda_des", "R"):
        for jp, tp in zip(getattr(jjrs, name), getattr(jrs, name)):
            assert jp.basis == tp.basis, name
            # the port's PZs carry the world axis B = 1 after G's gen axis
            for field, port in (("c", tp.c[0]), ("G", tp.G[:, 0]), ("r", tp.r[0])):
                np.testing.assert_allclose(np.asarray(getattr(jp, field)), port.numpy(),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{name}.{field}")
    for jpk, tpk in ((jax_pack_pzs(jrs_.link_pz, axis=1), pack_pzs(rs.link_pz, axis=2)),
                     (jax_pack_pzs(jrs_.u_nom, axis=-1), pack_pzs(rs.u_nom, axis=-1))):
        assert jpk.basis == tpk.basis
        np.testing.assert_allclose(np.asarray(jpk.c), tpk.c[0].numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(jpk.G), tpk.G[:, 0].numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(jpk.r), tpk.r[0].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(jrs_.torque_radius), rs.torque_radius[0].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_own_kinova_spec_matches_jax():
    """The port's own copy of the Kinova Gen3 spec equals the JAX one, field
    by field, and ``convert.spec_from_arrays`` carries the JAX fields over
    (mesh paths wait for the sim slice)."""
    jspec, tspec = jax_kinova_gen3_spec(), kinova_gen3_spec()
    fields = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)}
    carried = convert.spec_from_arrays(**dict(fields, mesh_paths=None))
    for f in dataclasses.fields(tspec):
        for spec in (tspec, carried):
            if f.name != "mesh_paths":
                np.testing.assert_array_equal(np.asarray(getattr(spec, f.name)),
                                              np.asarray(fields[f.name]), err_msg=f.name)
    assert (tspec.qe, tspec.qde, tspec.qddae) == (jspec.qe, jspec.qde, jspec.qddae)
