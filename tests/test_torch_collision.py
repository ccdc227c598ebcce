"""Parity of the port's hyperplane bank and of the collision kernels' plain
versions with the JAX package, on the CPU.

The bank is the one of `tests/test_pallas.py::_build_problem` (built by the
JAX planner, carried over by `armour_tpu_torch.convert`), in float64 and in
the production float32 with bf16 normals.  The JAX side runs its portable
``impl="xla"`` pipeline, never the Pallas kernels.  On CPU tensors the
port's kernel wrappers run their plain versions.

The multi-start entry points are also held to JAX at 10 and 26 starts,
more than one start group of the CUDA kernels holds (4 with the Jacobian,
16 without; the plain version is what the card tests hold those launches
to), and a planner with ``nlp_num_starts=10`` plans like the JAX planner
with the same starts.

Tolerances: float64 values at atol 1e-12; float32 at atol 2e-6 (the
Pallas tests' own); Jacobians on the slots whose winning hyperplane is
unique (top-2 gap over the 2P pieces > 1e-5, `test_pallas.py::_tie_mask`),
where any other selection is an equally valid subgradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision.zonotope import ObstacleSet as JaxObstacleSet
from armour_tpu.collision.zonotope import buffer_obstacles as jax_buffer_obstacles
from armour_tpu.collision.zonotope import (
    collision_constraints_with_jac as jax_cj,
    collision_constraints_with_jac_multi as jax_cj_multi,
    collision_values_multi as jax_values_multi,
)
from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu.planner.armour import ArmourPlanner as JaxPlanner
from armour_tpu.robots.kinova import kinova_gen3_spec as jax_kinova_gen3_spec
from armour_tpu_torch import convert
from armour_tpu_torch.collision import kernels
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.planner.armour import ArmourPlanner
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.collision.zonotope import (
    ObstacleSet,
    buffer_obstacles,
    collision_constraints_with_jac,
    collision_constraints_with_jac_multi,
    collision_values_multi,
)
from test_pallas import _tie_mask

ATOL = {jnp.float64: 1e-12, jnp.float32: 2e-6}
TORCH_DTYPE = {jnp.float64: torch.float64, jnp.float32: torch.float32}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are a few worlds wide: one intra-op thread
    runs them as fast as eight, and leaves the cores to the JAX compiles
    and to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _build_problem(rng, dtype, n_obs=3):
    """`test_pallas.py::_build_problem` at a chosen dtype."""
    spec = jax_kinova_gen3_spec()
    cfg = JaxPlannerConfig(num_time_steps=16, max_obstacles=8)
    planner = JaxPlanner(spec, cfg, dtype=dtype)
    q0 = jnp.asarray(rng.uniform(-1, 1, 7), dtype)
    obs = JaxObstacleSet.from_boxes(
        rng.uniform(-0.6, 0.6, (n_obs, 3)), rng.uniform(0.05, 0.3, (n_obs, 3)), 8, dtype)
    return jax.jit(planner._make_build_fn())(
        q0, jnp.zeros(7, dtype), jnp.zeros(7, dtype), obs.zonos, obs.mask)


_PROBLEMS = {}


def _shared_problem(rng, dtype):
    """`_build_problem` once per dtype and generator state: each build
    compiles the JAX build function afresh, so the cases that differ only in
    the start count share one.  ``rng`` is left where the build leaves it."""
    key = (jnp.dtype(dtype).name, str(rng.bit_generator.state))
    if key not in _PROBLEMS:
        _PROBLEMS[key] = (_build_problem(rng, dtype), rng.bit_generator.state)
    prob, rng.bit_generator.state = _PROBLEMS[key]
    return prob


def _port(prob, dtype):
    links = (prob.links.c, prob.links.G, prob.links.r, prob.links.basis)
    hp = (prob.hp.A, prob.hp.dpos, prob.hp.dneg, prob.hp.obs_mask)
    return (convert.packed_pz_from_numpy(*links, device="cpu", dtype=TORCH_DTYPE[dtype]),
            convert.bank_from_numpy(*hp, device="cpu", dtype=TORCH_DTYPE[dtype]))


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_buffer_obstacles_matches_jax(rng, dtype):
    """The bank from the same link generators and boxes; f32 stores A in
    bf16 with the offsets computed for the quantized normals."""
    T, L = 6, 4
    gens = rng.uniform(-0.06, 0.06, (T, L, 3, 6))
    obs = JaxObstacleSet.from_boxes(
        [[0.4, 0.2, 0.3], [-0.2, -0.4, 0.5]], [[0.25, 0.15, 0.2], [0.3, 0.2, 0.25]], 4, dtype)
    bf16 = dtype == jnp.float32
    hp_j = jax_buffer_obstacles(jnp.asarray(gens, dtype), obs, slack=1e-5, store_bf16=bf16)
    td = TORCH_DTYPE[dtype]
    hp_t = buffer_obstacles(
        torch.as_tensor(gens, dtype=td)[None],
        ObstacleSet(torch.as_tensor(np.asarray(obs.zonos), dtype=td)[None],
                    torch.as_tensor(np.asarray(obs.mask))[None]),
        slack=1e-5, store_bf16=bf16)
    assert hp_t.A.dtype == (torch.bfloat16 if bf16 else td)
    np.testing.assert_allclose(np.asarray(hp_j.A, np.float64), hp_t.A[0].double().numpy(),
                               rtol=0, atol=ATOL[dtype])
    for name in ("dpos", "dneg"):
        np.testing.assert_allclose(np.asarray(getattr(hp_j, name)), getattr(hp_t, name)[0].numpy(),
                                   rtol=0, atol=ATOL[dtype] * 4)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_plain_kernels_match_jax_xla(rng, dtype):
    prob = _build_problem(rng, dtype)
    links, hp = _port(prob, dtype)
    S = 4
    K = rng.uniform(-0.9, 0.9, (S, 7))
    centers, _, dcenters = prob.links.slice_with_jac_multi(jnp.asarray(K, dtype))
    g_j, J_j = jax_cj_multi(prob.hp, centers, dcenters, impl="xla")     # (S,T,L,O), (S,T,L,O,n)
    gv_j = jax_values_multi(prob.hp, centers, impl="xla")
    c_t, _, dc_t = links.slice_with_jac_multi(torch.as_tensor(K, dtype=TORCH_DTYPE[dtype])[None])
    g_t, J_t = collision_constraints_with_jac_multi(hp, c_t, dc_t)        # (1,S,L,O,T), (1,S,n,L,O,T)
    gv_t = collision_values_multi(hp, c_t)
    atol = ATOL[dtype]
    np.testing.assert_allclose(np.asarray(g_j), g_t[0].permute(0, 3, 1, 2).numpy(), atol=atol)
    np.testing.assert_allclose(np.asarray(gv_j), gv_t[0].permute(0, 3, 1, 2).numpy(), atol=atol)
    unique = np.stack([np.asarray(_tie_mask(prob.hp, centers[s])) for s in range(S)])[..., None]
    J_tp = J_t[0].permute(0, 4, 2, 3, 1).numpy()
    np.testing.assert_allclose(np.asarray(J_j) * unique, J_tp * unique, atol=atol)
    # the single-start entry point
    g1_j, J1_j = jax_cj(prob.hp, centers[0], dcenters[0], impl="xla")
    g1_t, J1_t = collision_constraints_with_jac(hp, c_t[:, 0], dc_t[:, 0])
    np.testing.assert_allclose(np.asarray(g1_j), g1_t[0].permute(2, 0, 1).numpy(), atol=atol)
    np.testing.assert_allclose(np.asarray(J1_j) * unique[0],
                               J1_t[0].permute(3, 1, 2, 0).numpy() * unique[0], atol=atol)


def test_plain_kernel_tie_break_duplicated_obstacle(rng):
    """Duplicated obstacle banks (identical slabs in two O slots,
    `test_pallas.py:149-184`): identical values in both slots and
    tie-masked Jacobian parity in every start lane."""
    prob = _build_problem(rng, jnp.float64, n_obs=2)
    hp = prob.hp._replace(
        A=prob.hp.A.at[:, :, :, 1].set(prob.hp.A[:, :, :, 0]),
        dpos=prob.hp.dpos.at[:, :, 1].set(prob.hp.dpos[:, :, 0]),
        dneg=prob.hp.dneg.at[:, :, 1].set(prob.hp.dneg[:, :, 0]),
    )
    prob = prob._replace(hp=hp)
    links, hp_t = _port(prob, jnp.float64)
    S = 3
    K = rng.uniform(-0.9, 0.9, (S, 7))
    centers, _, dcenters = prob.links.slice_with_jac_multi(jnp.asarray(K))
    g_j, J_j = jax_cj_multi(hp, centers, dcenters, impl="xla")
    c_t, _, dc_t = links.slice_with_jac_multi(torch.as_tensor(K)[None])
    g_t, J_t = collision_constraints_with_jac_multi(hp_t, c_t, dc_t)
    g_t = g_t[0].permute(0, 3, 1, 2).numpy()
    np.testing.assert_array_equal(g_t[..., 0], g_t[..., 1])
    np.testing.assert_allclose(np.asarray(g_j), g_t, atol=1e-12)
    unique = np.stack([np.asarray(_tie_mask(hp, centers[s])) for s in range(S)])[..., None]
    np.testing.assert_allclose(np.asarray(J_j) * unique,
                               J_t[0].permute(0, 4, 2, 3, 1).numpy() * unique, atol=1e-12)


def test_plain_kernels_keep_first_maximum():
    """At an exact tie between two pairs the first one wins (strict '>'),
    and its sign follows vp >= vn, as in the Pallas kernels."""
    B, P, L, O, T, n = 1, 3, 1, 1, 2, 2
    A = torch.zeros((B, P, 3, L, O, T), dtype=torch.float64)
    A[:, 0, 0] = 1.0      # pair 0: +x
    A[:, 1, 1] = 1.0      # pair 1: +y, the same value at this center
    A[:, 2, 2] = 1.0      # pair 2: +z, lower
    dpos = torch.zeros((B, P, L, O, T), dtype=torch.float64)
    dneg = torch.full_like(dpos, 5.0)
    dpos[:, 2] = 1.0
    c = torch.zeros((B, 1, 3, L, T), dtype=torch.float64)
    c[:, 0, 0] = 0.5
    c[:, 0, 1] = 0.5
    dc = torch.randn((B, 1, n, 3, L, T), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    g, J = kernels.fused_collision_value_jac_multi(A, dpos, dneg, c, dc)
    np.testing.assert_array_equal(g.numpy(), -0.5)
    # winner: pair 0, + branch (vp >= vn) -> signed normal -A0 = (-1, 0, 0)
    np.testing.assert_array_equal(J[0, 0].numpy(), -dc[0, 0, :, 0].numpy()[:, :, None, :])
    assert kernels.fused_collision_value_jac_multi.launches == 0


def test_plain_kernels_skip_nan_pieces():
    """A pair with a NaN offset never wins, as in the CUDA and Pallas
    kernels; a slot with no usable pair keeps the running max's start
    (g = 1e30, J = 0) instead of turning NaN."""
    B, P, L, O, T, n = 1, 3, 1, 2, 2, 2
    A = torch.zeros((B, P, 3, L, O, T), dtype=torch.float64)
    A[:, 0, 0] = 1.0      # pair 0: +x, the best where usable
    A[:, 1, 1] = 1.0      # pair 1: +y, second
    A[:, 2, 2] = 1.0      # pair 2: +z
    dpos = torch.zeros((B, P, L, O, T), dtype=torch.float64)
    dpos[:, 1] = 0.25
    dpos[:, 2] = 1.0
    dneg = torch.full_like(dpos, 5.0)
    dpos[0, 0, 0, 0, 1] = torch.nan          # slot (o=0, t=1): pair 0 unusable
    dneg[0, :, 0, 1, 1] = torch.nan          # slot (o=1, t=1): no usable pair
    c = torch.zeros((B, 1, 3, L, T), dtype=torch.float64)
    c[:, 0, 0] = 0.5
    c[:, 0, 1] = 0.5
    dc = torch.randn((B, 1, n, 3, L, T), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    kernels.reset_launch_counts()
    g, J = kernels.fused_collision_value_jac_multi(A, dpos, dneg, c, dc)
    gv = kernels.fused_collision_values_multi(A, dpos, dneg, c)
    np.testing.assert_array_equal(g.numpy(), gv.numpy())
    g, J = g[0, 0, 0], J[0, 0, :, 0]                          # (O, T), (n, O, T)
    np.testing.assert_array_equal(g.numpy(), [[-0.5, -0.25], [-0.5, 1e30]])
    np.testing.assert_array_equal(J[:, 0, 0].numpy(), -dc[0, 0, :, 0, 0, 0].numpy())
    np.testing.assert_array_equal(J[:, 0, 1].numpy(), -dc[0, 0, :, 1, 0, 1].numpy())
    np.testing.assert_array_equal(J[:, 1, 1].numpy(), 0.0)
    assert not bool(kernels.tie_mask(A, dpos, dneg, c)[0, 0, 0, 1, 1])
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}


@pytest.mark.parametrize("S", [10, 26])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_plain_kernels_match_jax_xla_many_starts(rng, dtype, S):
    """S = 10 and 26 (the smooth-mode pool of a 12-start plan): more starts
    than one start group of the CUDA kernels holds (4 with the Jacobian, 16
    without; a launch takes any S); the plain version takes any S at once.
    Values and tie-masked Jacobians of every start lane against the JAX
    pipeline."""
    prob = _shared_problem(rng, dtype)
    links, hp = _port(prob, dtype)
    K = rng.uniform(-0.9, 0.9, (S, 7))
    centers, _, dcenters = prob.links.slice_with_jac_multi(jnp.asarray(K, dtype))
    g_j, J_j = jax_cj_multi(prob.hp, centers, dcenters, impl="xla")
    gv_j = jax_values_multi(prob.hp, centers, impl="xla")
    c_t, _, dc_t = links.slice_with_jac_multi(torch.as_tensor(K, dtype=TORCH_DTYPE[dtype])[None])
    kernels.reset_launch_counts()
    g_t, J_t = collision_constraints_with_jac_multi(hp, c_t, dc_t)
    gv_t = collision_values_multi(hp, c_t)
    assert kernels.launch_counts() == {k.__name__: 0 for k in kernels.KERNELS}
    assert g_t.shape[:2] == (1, S) and J_t.shape[:3] == (1, S, 7)
    atol = ATOL[dtype]
    np.testing.assert_allclose(np.asarray(g_j), g_t[0].permute(0, 3, 1, 2).numpy(), atol=atol)
    np.testing.assert_allclose(np.asarray(gv_j), gv_t[0].permute(0, 3, 1, 2).numpy(), atol=atol)
    unique = np.stack([np.asarray(_tie_mask(prob.hp, centers[s])) for s in range(S)])[..., None]
    np.testing.assert_allclose(np.asarray(J_j) * unique,
                               J_t[0].permute(0, 4, 2, 3, 1).numpy() * unique, atol=atol)
    # the lanes do not depend on how the starts are grouped
    g_a, J_a = collision_constraints_with_jac_multi(hp, c_t[:, :8], dc_t[:, :8])
    g_b, J_b = collision_constraints_with_jac_multi(hp, c_t[:, 8:], dc_t[:, 8:])
    assert torch.equal(torch.cat([g_a, g_b], 1), g_t) and torch.equal(torch.cat([J_a, J_b], 1), J_t)


def test_plan_with_ten_starts_matches_jax():
    """``nlp_num_starts=10``: the port plans on the CPU like the JAX planner
    with the same random starts (T=16, 4 obstacle slots, float64): the same
    verdict, k at atol 1e-6."""
    kw = dict(num_time_steps=16, max_obstacles=4, nlp_num_starts=10,
              nlp_outer_iters=8, nlp_inner_iters=8)
    jp = JaxPlanner(jax_kinova_gen3_spec(), JaxPlannerConfig(**kw))
    tp = ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**kw), dtype=torch.float64, device="cpu")
    q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
    qd0 = np.random.default_rng(0).uniform(-0.3, 0.3, 7)
    centers, sides = [[0.4, 0.2, 0.3], [0.1, -0.4, 0.5]], [[0.1, 0.1, 0.1], [0.2, 0.1, 0.15]]
    q_des = q0 + 0.8 * jp.cfg.k_range
    key = jax.random.PRNGKey(0)
    res_j = jp.plan(q0, qd0, np.zeros(7), q_des,
                    JaxObstacleSet.from_boxes(np.array(centers), np.array(sides), 4), key)
    # the random starts the JAX solve draws from ``key``
    k_rand = np.asarray(jax.random.uniform(key, (kw["nlp_num_starts"] - 2, 7), jnp.float64,
                                           minval=-0.6, maxval=0.6))
    res_t = tp.plan(q0, qd0, np.zeros(7), q_des, ObstacleSet.from_boxes(centers, sides, 4),
                    k_rand=k_rand)
    assert bool(res_j.feasible) and bool(res_t.feasible)
    np.testing.assert_allclose(np.asarray(res_j.k), res_t.k.numpy(), rtol=0, atol=1e-6)
