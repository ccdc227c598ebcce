"""The public functions of the port's `ops/pz.py` and `ops/interval.py`
that the JAX package's callers use outside the planner (its tests, and
`armour_tpu/utils/plotting.py`'s ``links.slice``), held against
`armour_tpu.ops` on the CPU in float64.

The same inputs, made with ``numpy.random.default_rng(seed)``, go through
both packages' own constructors (``PZ.from_gens``, ``PZ.from_uncertain``,
``pz_zeros_vec``, ``pack_pzs``); the packed set is a link set at T=8 (7
links, one 3-vector per time step, each on its own degree-2 k basis).
Tolerance: rtol 1e-12.  No JAX planner is compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.ops import interval as jiv
from armour_tpu.ops import pz as jpz
from armour_tpu_torch.ops import interval as tiv
from armour_tpu_torch.ops import pz as tpz

RTOL = 1e-12
ATOL = 1e-14
T, L, NK = 8, 7, 7


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL, atol=ATOL)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _k_basis(rng, n):
    """``n`` distinct k monomials of degree 1 and 2."""
    keys = set()
    while len(keys) < n:
        a, b = (int(v) for v in rng.integers(0, NK, 2))
        keys.add(((a, 1),) if rng.random() < 0.4 else
                 (((a, 2),) if a == b else tuple(sorted(((a, 1), (b, 1))))))
    return sorted(keys)


def _pz_pair(rng, shape, nval, n_gens=6):
    """The same PZ from both packages' ``from_gens``: (jax PZ, torch PZ)."""
    c = rng.normal(size=shape)
    keys = _k_basis(rng, n_gens)
    coeffs = [0.3 * rng.normal(size=shape) for _ in keys]
    r = 0.05 * np.abs(rng.normal(size=shape))
    return (jpz.PZ.from_gens(jnp.asarray(c), keys, [jnp.asarray(g) for g in coeffs],
                             r=jnp.asarray(r), nval=nval),
            tpz.PZ.from_gens(_t(c), keys, [_t(g) for g in coeffs], r=_t(r), nval=nval))


def _same_pz(jp, tp):
    assert jp.basis == tp.basis and jp.nval == tp.nval
    for a, b in ((jp.c, tp.c), (jp.G, tp.G), (jp.r, tp.r)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


@pytest.mark.parametrize("nval", [None, 0, 1])
def test_from_uncertain_and_batch_shape(nval):
    rng = np.random.default_rng(1)
    c = rng.normal(size=(2, T, 3))
    jp = jpz.PZ.from_uncertain(jnp.asarray(c), 0.03, nval=nval)
    tp = tpz.PZ.from_uncertain(_t(c), 0.03, nval=nval)
    _same_pz(jp, tp)
    assert tuple(tp.batch_shape) == tuple(jp.batch_shape)
    assert tuple(tp.val_shape) == tuple(jp.val_shape)
    # a PZ of generators keeps its batch and value split
    jq, tq = _pz_pair(rng, (2, T, 3, 3), nval=2)
    assert tuple(tq.batch_shape) == tuple(jq.batch_shape) == (2, T)


@pytest.mark.parametrize("batch", [(), (T,), (2, T)])
def test_pz_zeros_vec(batch):
    jp = jpz.pz_zeros_vec(batch, dtype=jnp.float64)
    tp = tpz.pz_zeros_vec(batch, dtype=torch.float64, device="cpu")
    _same_pz(jp, tp)
    assert tp.c.dtype == torch.float64 and tp.c.device.type == "cpu"


@pytest.mark.parametrize("seed", [2, 3])
def test_pz_monomials_and_slice(seed):
    rng = np.random.default_rng(seed)
    jp, tp = _pz_pair(rng, (T, 3), nval=1)
    for k in rng.uniform(-1.0, 1.0, (3, NK)):
        _close(jp.monomials(jnp.asarray(k)), tp.monomials(_t(k)))
        for a, b in zip(jp.slice(jnp.asarray(k)), tp.slice(_t(k))):
            _close(a, b)
    # a PZ with no generator slices to its center
    jc, tc = jpz.PZ.const(jnp.asarray(jp.c)), tpz.PZ.const(tp.c.clone())
    k = rng.uniform(-1.0, 1.0, NK)
    assert tc.monomials(_t(k)).shape == (0,)
    for a, b in zip(jc.slice(jnp.asarray(k)), tc.slice(_t(k))):
        _close(a, b)


def _packed_links(rng):
    """A packed link set at T=8: 7 link-center PZs (T, 3), each on its own
    basis, packed on axis 1 -> c (T, L, 3)."""
    pairs = [_pz_pair(rng, (T, 3), nval=1, n_gens=int(rng.integers(3, 9))) for _ in range(L)]
    return (jpz.pack_pzs([p[0] for p in pairs], axis=1),
            tpz.pack_pzs([p[1] for p in pairs], axis=1))


@pytest.mark.parametrize("seed", [4, 5])
def test_packed_monomials_slice_and_slice_with_jac(seed):
    rng = np.random.default_rng(seed)
    jpk, tpk = _packed_links(rng)
    assert jpk.basis == tpk.basis and tuple(tpk.c.shape) == (T, L, 3)
    for k in rng.uniform(-1.0, 1.0, (3, NK)):
        jk, tk = jnp.asarray(k), _t(k)
        _close(jpk.monomials(jk), tpk.monomials(tk))
        for a, b in zip(jpk.slice(jk), tpk.slice(tk)):
            _close(a, b)
        got = tpk.slice_with_jac(tk)
        want = jpk.slice_with_jac(jk)
        assert tuple(got[2].shape) == tuple(want[2].shape) == (NK, T, L, 3)
        for a, b in zip(want, got):
            _close(a, b)
        # the single-start Jacobian is the autodiff Jacobian of the slice
        auto = jnp.moveaxis(jax.jacfwd(lambda kk: jpk.slice(kk)[0])(jk), -1, 0)
        _close(auto, got[2])


def test_packed_slice_without_generators():
    rng = np.random.default_rng(6)
    c, r = rng.normal(size=(T, L, 3)), np.abs(rng.normal(size=(T, L, 3)))
    jpk = jpz.pack_pzs([jpz.PZ.const(jnp.asarray(c[:, i]), r=jnp.asarray(r[:, i]))
                        for i in range(L)], axis=1)
    tpk = tpz.pack_pzs([tpz.PZ.const(_t(c[:, i]), r=_t(r[:, i])) for i in range(L)], axis=1)
    k = rng.uniform(-1.0, 1.0, NK)
    assert tpk.monomials(_t(k)).shape == (0,)
    for a, b in zip(jpk.slice(jnp.asarray(k)), tpk.slice(_t(k))):
        _close(a, b)
    for a, b in zip(jpk.slice_with_jac(jnp.asarray(k)), tpk.slice_with_jac(_t(k))):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


def test_packed_slice_with_jac_is_a_start_of_the_multi_slice():
    """``slice_with_jac`` at one k equals ``slice_with_jac_multi`` at that k
    for every row of the leading axis, its Jacobian axis moved first."""
    rng = np.random.default_rng(7)
    _, tpk = _packed_links(rng)
    k = _t(rng.uniform(-1.0, 1.0, NK))
    c, r, dc = tpk.slice_with_jac(k)
    cm, rm, dcm = tpk.slice_with_jac_multi(k.expand(T, 1, NK))
    torch.testing.assert_close(c, cm[:, 0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(r, rm, rtol=0, atol=0)
    torch.testing.assert_close(dc, dcm[:, 0].movedim(1, 0), rtol=RTOL, atol=ATOL)


def test_interval_from_center_radius_abs_sup_contains():
    rng = np.random.default_rng(8)
    c = rng.normal(size=(T, 7))
    r = np.abs(rng.normal(size=(T, 7)))
    x = c + rng.uniform(-1.6, 1.6, (T, 7)) * r
    ji = jiv.Interval.from_center_radius(jnp.asarray(c), jnp.asarray(r))
    ti = tiv.Interval.from_center_radius(_t(c), _t(r))
    _close(ji.lo, ti.lo)
    _close(ji.hi, ti.hi)
    _close(ji.abs_sup(), ti.abs_sup())
    for atol in (0.0, 0.1):
        want = np.asarray(ji.contains(jnp.asarray(x), atol=atol))
        got = ti.contains(_t(x), atol=atol).numpy()
        np.testing.assert_array_equal(want, got)
        assert want.any() and not want.all()
