"""Parity of the port's interval and polynomial-zonotope ops and its small
SPD solve with the JAX package, on the CPU in float64.

The same inputs, made with numpy from a seed, go through `armour_tpu.ops`
and `armour_tpu_torch.ops`.  Tolerance: rtol 1e-12 (the two compute the
same expressions; only the summation order inside an einsum/matmul may
differ, which moves f64 results by a few ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.ops import interval as jiv
from armour_tpu.ops import linalg as jlinalg
from armour_tpu.ops import pz as jpz
from armour_tpu_torch.ops import interval as tiv
from armour_tpu_torch.ops import linalg as tlinalg
from armour_tpu_torch.ops import pz as tpz

RTOL = 1e-12
ATOL = 1e-14


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b,
                               rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _pair(rng, basis, batch, val):
    """The same random PZ in both packages: (jax PZ, torch PZ)."""
    shape = batch + val
    c = rng.normal(size=shape)
    G = rng.normal(size=(len(basis),) + shape) * 0.3
    r = np.abs(rng.normal(size=shape)) * 0.05
    nval = len(val)
    return (jpz.PZ(jnp.asarray(c), jnp.asarray(G), jnp.asarray(r), basis, nval),
            tpz.PZ(_t(c), _t(G), _t(r), basis, nval))


def _same_pz(jp, tp):
    assert jp.basis == tp.basis and jp.nval == tp.nval
    _close(jp.c, tp.c)
    _close(jp.G, tp.G)
    _close(jp.r, tp.r)


BASIS_A = (((0, 1),), ((0, 1), (1, 1)), ((1, 1),), ((jpz.SHAPE_X, 1),))
BASIS_B = (((1, 1),), ((2, 1),), ((2, 2),), ((jpz.SHAPE_Y, 1),))


def test_interval_ops_match_jax(rng):
    lo = rng.uniform(-8.0, 8.0, 200)
    hi = lo + rng.uniform(0.0, 7.0, 200)
    lo2 = rng.uniform(-2.0, 2.0, 200)
    hi2 = lo2 + rng.uniform(0.0, 1.0, 200)
    ji, ti = jiv.Interval(jnp.asarray(lo), jnp.asarray(hi)), tiv.Interval(_t(lo), _t(hi))
    ji2, ti2 = jiv.Interval(jnp.asarray(lo2), jnp.asarray(hi2)), tiv.Interval(_t(lo2), _t(hi2))
    cases = [
        (jiv.icos(ji), tiv.icos(ti)),
        (jiv.isin(ji), tiv.isin(ti)),
        (ji * ji2, ti * ti2),
        (ji * 0.5, ti * 0.5),
        (ji2.square(), ti2.square()),
        (ji - ji2, ti - ti2),
        (ji.union(ji2), ti.union(ti2)),
    ]
    for jr, tr in cases:
        _close(jr.lo, tr.lo)
        _close(jr.hi, tr.hi)


@pytest.mark.parametrize("op", ["mul", "matmat", "matvec", "cross", "dot", "add", "set_component"])
def test_pz_products_match_jax(rng, op):
    batch = (2, 3)
    if op == "mul":
        a, b = _pair(rng, BASIS_A, batch, ()), _pair(rng, BASIS_B, batch, ())
        jr, tr = jpz.pz_mul(a[0], b[0]), tpz.pz_mul(a[1], b[1])
    elif op == "matmat":
        a, b = _pair(rng, BASIS_A, batch, (3, 3)), _pair(rng, BASIS_B, batch, (3, 3))
        jr, tr = jpz.pz_matmat(a[0], b[0]), tpz.pz_matmat(a[1], b[1])
    elif op == "matvec":
        a, b = _pair(rng, BASIS_A, batch, (3, 3)), _pair(rng, BASIS_B, (), (3,))
        jr, tr = jpz.pz_matvec(a[0], b[0]), tpz.pz_matvec(a[1], b[1])
    elif op == "cross":
        a, b = _pair(rng, BASIS_A, batch, (3,)), _pair(rng, BASIS_A, batch, (3,))
        jr, tr = jpz.pz_cross(a[0], b[0]), tpz.pz_cross(a[1], b[1])
    elif op == "dot":
        a, b = _pair(rng, BASIS_A, batch, (3,)), _pair(rng, BASIS_B, batch, (3,))
        jr, tr = jpz.pz_dot(a[0], b[0]), tpz.pz_dot(a[1], b[1])
    elif op == "add":
        a, b = _pair(rng, BASIS_A, batch, (3,)), _pair(rng, BASIS_B, batch, (3,))
        jr, tr = a[0] + b[0] - a[0].scale(0.5), a[1] + b[1] - a[1].scale(0.5)
    else:
        a, b = _pair(rng, BASIS_A, batch, (3,)), _pair(rng, BASIS_B, batch, ())
        jr, tr = jpz.pz_set_component(a[0], 1, b[0]), tpz.pz_set_component(a[1], 1, b[1])
    _same_pz(jr, tr)


def test_pz_reductions_stack_and_rotation_match_jax(rng):
    a = _pair(rng, BASIS_A + (((jpz.SHAPE_Z, 1),), ((0, 1), (jpz.SHAPE_X, 1))), (4,), (3,))
    _same_pz(a[0].reduce(), a[1].reduce())
    jk, jg = a[0].reduce_link()
    tk, tg = a[1].reduce_link()
    _same_pz(jk, tk)
    _close(jg, tg)
    for j, t in zip(a[0].to_interval(), a[1].to_interval()):
        _close(j, t)
    s = [_pair(rng, basis, (4,), ()) for basis in (BASIS_A[:2], BASIS_B[:1], ())]
    _same_pz(jpz.pz_stack([p[0] for p in s]), tpz.pz_stack([p[1] for p in s]))
    cos = _pair(rng, (((3, 1),),), (5,), ())
    sin = _pair(rng, (((3, 1),),), (5,), ())
    fixed = rng.normal(size=(3, 3))
    for axis in (1, -2, 3):
        _same_pz(jpz.rot_from_cos_sin(cos[0], sin[0], axis, fixed),
                 tpz.rot_from_cos_sin(cos[1], sin[1], axis, fixed))


def test_packed_slice_with_jac_multi_matches_jax(rng):
    basis = (((0, 1),), ((0, 1), (3, 1)), ((2, 2),), ((5, 1),), ((6, 2),))
    pzs = [_pair(rng, basis[i:], (6, 4), (3,)) for i in range(3)]
    jpk = jpz.pack_pzs([p[0] for p in pzs], axis=1)
    tpk = tpz.pack_pzs([p[1] for p in pzs], axis=1)
    assert jpk.basis == tpk.basis
    K = rng.uniform(-1.0, 1.0, (5, 7))
    jc, jr, jdc = jpk.slice_with_jac_multi(jnp.asarray(K))
    # the port's packed PZ carries a leading world axis: add B = 1
    tpk1 = tpz.PackedPZ(tpk.c[None], tpk.G[:, None], tpk.r[None], tpk.basis)
    tc, tr, tdc = tpk1.slice_with_jac_multi(_t(K)[None])
    _close(jc, tc[0])
    _close(jr, tr[0])
    _close(jdc, tdc[0])


def test_spd_solve_small_matches_jax(rng):
    M = rng.normal(size=(6, 7, 7))
    H = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(7)
    g = rng.normal(size=(6, 7))
    x_j = np.asarray(jlinalg.spd_solve_small(jnp.asarray(H), jnp.asarray(g)))
    x_t = tlinalg.spd_solve_small(_t(H), _t(g))
    _close(x_j, x_t)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", H, x_t.numpy()), g, rtol=1e-10, atol=1e-12)
