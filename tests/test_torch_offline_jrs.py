"""The port's offline ARMTD-set module (`armour_tpu_torch/jrs/offline.py`)
against the JAX package's numpy functions (`armour_tpu/jrs/offline.py`).

``zonotope_slice`` and ``sliced_cos_sin_intervals`` on 6-row zonotopes
built here (one k_a and one k_v generator each, the other generators free
of both dims), f64, atol 1e-12: a k_v slice, a k_a slice, the q0 rotation
of the (cos, sin) block, and the assertions on a value outside the set and
on a dim with two slice generators.  The loader runs only where the
reference's ``.mat`` files are present (as `tests/test_armtd.py` does).
"""

import numpy as np
import pytest
import torch

from armour_tpu.jrs import offline as jax_offline
from armour_tpu_torch.jrs import offline

DIM_KA, DIM_KV = offline.DIM_KA, offline.DIM_KV
N_T = 5


def _zonotope(rng, n_free=4):
    """(6, 1 + n_free + 2): center, free generators (zero in the k_a and
    k_v rows), then the k_a and the k_v generator, in shuffled order."""
    c = rng.uniform(-1.0, 1.0, 6)
    free = rng.normal(scale=0.05, size=(6, n_free))
    free[[DIM_KA, DIM_KV]] = 0.0
    ka = rng.normal(scale=0.05, size=6)
    ka[DIM_KA], ka[DIM_KV] = rng.uniform(0.2, 0.5), 0.0
    kv = rng.normal(scale=0.05, size=6)
    kv[DIM_KA], kv[DIM_KV] = 0.0, rng.uniform(0.2, 0.5)
    G = np.concatenate([free, ka[:, None], kv[:, None]], axis=1)
    return np.concatenate([c[:, None], G[:, rng.permutation(G.shape[1])]], axis=1)


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    Z = [_zonotope(rng) for _ in range(N_T)]
    # the same centre rows in the k dims, so one slice value is inside every set
    for z in Z[1:]:
        z[[DIM_KA, DIM_KV], 0] = Z[0][[DIM_KA, DIM_KV], 0]
    return Z


@pytest.mark.parametrize("dim", [DIM_KV, DIM_KA])
def test_zonotope_slice_matches_jax(sets, dim):
    Z = sets[0]
    c, g = Z[dim, 0], np.abs(Z[dim, 1:]).max()
    for lam in (-1.0, -0.3, 0.0, 0.7, 1.0):
        value = c + lam * g
        got = offline.zonotope_slice(torch.as_tensor(Z), dim, value, device="cpu")
        ref = jax_offline.zonotope_slice(Z, dim, value)
        assert got.dtype == torch.float64 and got.shape == ref.shape == (6, Z.shape[1] - 1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("q0_j", [0.0, 0.9, -2.4])
def test_sliced_cos_sin_intervals_match_jax(sets, q0_j):
    kv0, ka0 = sets[0][DIM_KV, 0], sets[0][DIM_KA, 0]
    qd0_j, k_actual = kv0 + 0.05, ka0 - 0.1
    got = offline.sliced_cos_sin_intervals(offline.OfflineJRS(0.0, 0.5, 1.0, sets), q0_j, qd0_j,
                                           k_actual, device="cpu")
    ref = jax_offline.sliced_cos_sin_intervals(jax_offline.OfflineJRS(0.0, 0.5, 1.0, sets), q0_j,
                                               qd0_j, k_actual)
    for g, r in zip(got[:4], ref[:4]):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float64 and g.shape == (N_T,)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-12)
    assert isinstance(got[4], float) and got[4] == pytest.approx(ref[4], abs=1e-12)
    assert np.all(got[0].numpy() <= got[1].numpy()) and np.all(got[2].numpy() <= got[3].numpy())


def test_slice_outside_the_set_or_with_two_generators_raises(sets):
    Z = sets[0]
    outside = Z[DIM_KV, 0] + 1.5 * np.abs(Z[DIM_KV, 1:]).max()
    for mod in (offline, jax_offline):
        kw = {"device": "cpu"} if mod is offline else {}
        with pytest.raises(AssertionError, match="outside the set"):
            mod.zonotope_slice(Z, DIM_KV, outside, **kw)
    two = np.concatenate([Z, np.zeros((6, 1))], axis=1)
    two[DIM_KV, -1] = 0.1                      # a second k_v generator
    assert np.count_nonzero(two[DIM_KV, 1:]) == 2
    for mod in (offline, jax_offline):
        kw = {"device": "cpu"} if mod is offline else {}
        with pytest.raises(AssertionError, match="expected one slice generator"):
            mod.zonotope_slice(two, DIM_KV, Z[DIM_KV, 0], **kw)


def test_loader_matches_jax():
    """The reference's offline sets through both loaders (skips while the
    ``.mat`` files are absent)."""
    if not offline.available():
        pytest.skip("reference offline_jrs .mat files not mounted")
    qd0_j = 0.35
    got, ref = offline.load_offline_jrs(qd0_j), jax_offline.load_offline_jrs(qd0_j)
    assert got[:3] == ref[:3] and len(got.Z) == len(ref.Z) == 100
    for a, b in zip(got.Z, ref.Z):
        np.testing.assert_array_equal(a, b)
    g = offline.sliced_cos_sin_intervals(got, 0.3, qd0_j, 0.0, device="cpu")
    r = jax_offline.sliced_cos_sin_intervals(ref, 0.3, qd0_j, 0.0)
    for a, b in zip(g[:4], r[:4]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12)
