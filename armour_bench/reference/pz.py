"""Frozen copy of ``armour_tpu_torch/ops/pz.py`` (plain PyTorch), kept with the
benchmark so that a later change to the program cannot move the yardstick.
Only its imports differ.  The original's docstring follows.

Static-basis polynomial zonotopes in PyTorch.

Port of `armour_tpu/ops/pz.py` (see its module docstring for the design).
A PZ value is::

    {x : x = c + sum_i G_i * m_i(k, s) + [-r, r],   k in [-1,1]^7, s in [-1,1]^3}

with ``c: (*batch, *val)``, ``G: (NG, *batch, *val)``, ``r: (*batch, *val)``
and a static monomial basis (a tuple of ((var, exp), ...) keys) shared by
every batch element.  The port's batch is ``(B, T)``: worlds x time steps.

JAX does the basis bookkeeping once, at trace time.  Eager PyTorch would
redo it on every call, so every index map is cached per basis pair (and per
device, for the index tensors): the host pays for it once per process.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
from armour_bench.reference.device import const, resolve_device

# variable index space: 0..n_factors-1 are trajectory parameters k_i;
# SHAPE_X.. are the reserved link-shape generator variables that must
# survive forward kinematics symbolically
SHAPE_X = 100
SHAPE_Y = 101
SHAPE_Z = 102
_SHAPE_VARS = (SHAPE_X, SHAPE_Y, SHAPE_Z)

MonKey = tuple  # tuple[(var:int, exp:int), ...] sorted by var

DEFAULT_MAX_DEGREE = 2


def _k_degree(key: MonKey) -> int:
    return sum(e for v, e in key if v < SHAPE_X)


def _shape_degree(key: MonKey) -> int:
    return sum(e for v, e in key if v >= SHAPE_X)


def _mul_keys(a: MonKey, b: MonKey) -> MonKey:
    d: dict[int, int] = {}
    for v, e in a:
        d[v] = d.get(v, 0) + e
    for v, e in b:
        d[v] = d.get(v, 0) + e
    return tuple(sorted(d.items()))


def _keep(key: MonKey, max_deg: int) -> bool:
    return _k_degree(key) <= max_deg and _shape_degree(key) <= 1


def _like(x, c: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype and on the device of ``c``; host data through
    ``device.const``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=c.dtype, device=c.device)
    return const(x, c.dtype, c.device)


@functools.lru_cache(maxsize=None)
def _positions(keys: tuple, basis: tuple, device: torch.device) -> torch.Tensor:
    """Index of every key of ``keys`` in ``basis``, as a device tensor."""
    return torch.tensor([basis.index(k) for k in keys], dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _index(idx: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(idx, dtype=torch.long, device=device)


@dataclasses.dataclass(frozen=True)
class PZ:
    """Polynomial zonotope with a static monomial basis.

    ``nval`` is the number of trailing value dimensions (0 scalar, 1 vector,
    2 matrix); any leading dimensions are batch and broadcast through every
    operation.
    """

    c: torch.Tensor
    G: torch.Tensor  # (NG, *c.shape); NG == len(basis), may be 0
    r: torch.Tensor
    basis: tuple = ()
    nval: int = 0

    # -- constructors ----------------------------------------------------
    @staticmethod
    def const(c: torch.Tensor, nval: int | None = None, r=None) -> "PZ":
        if nval is None:
            nval = c.ndim
        r_arr = torch.zeros_like(c) if r is None else _like(r, c).expand(c.shape)
        return PZ(c, c.new_zeros((0,) + c.shape), r_arr, (), nval)

    @staticmethod
    def from_uncertain(c: torch.Tensor, uncertainty_percent: float,
                       nval: int | None = None) -> "PZ":
        """center +/- uncertainty*|center| as pure interval (PZsparse.cu:93-98)."""
        return PZ.const(c, nval=nval, r=uncertainty_percent * c.abs())

    @staticmethod
    def from_gens(c: torch.Tensor, keys: Sequence[MonKey], coeffs: Sequence, r=None,
                  nval: int | None = None) -> "PZ":
        """Build from explicit monomials; duplicate keys are merged."""
        if nval is None:
            nval = c.ndim
        merged: dict[MonKey, torch.Tensor] = {}
        for key, g in zip(keys, coeffs):
            key = tuple(sorted((v, e) for v, e in key if e > 0))
            g = _like(g, c).expand(c.shape)
            merged[key] = merged[key] + g if key in merged else g
        r_arr = torch.zeros_like(c) if r is None else _like(r, c).expand(c.shape)
        if () in merged:  # constant monomial folds into the center
            c = c + merged.pop(())
        basis = tuple(sorted(merged.keys()))
        if basis:
            G = torch.stack([merged[k] for k in basis])
        else:
            G = c.new_zeros((0,) + c.shape)
        return PZ(c, G, r_arr, basis, nval)

    # -- helpers ---------------------------------------------------------
    @property
    def ngens(self) -> int:
        return len(self.basis)

    @property
    def batch_shape(self):
        return self.c.shape[:self.c.ndim - self.nval]

    @property
    def val_shape(self):
        return self.c.shape[self.c.ndim - self.nval:]

    def abs_sum(self) -> torch.Tensor:
        """|c| + sum_i |G_i| (radius contribution of the polynomial part)."""
        s = self.c.abs()
        if self.ngens:
            s = s + self.G.abs().sum(0)
        return s

    def _with_basis(self, new_basis: tuple) -> torch.Tensor:
        """Return G re-indexed onto a superset basis (static scatter)."""
        if new_basis == self.basis:
            return self.G
        G = self.c.new_zeros((len(new_basis),) + self.c.shape)
        if self.ngens:
            G[_positions(self.basis, new_basis, self.c.device)] = self.G
        return G

    # -- linear ops ------------------------------------------------------
    def __neg__(self) -> "PZ":
        return PZ(-self.c, -self.G, self.r, self.basis, self.nval)

    def __add__(self, other) -> "PZ":
        if not isinstance(other, PZ):
            return PZ(self.c + other, self.G, self.r, self.basis, self.nval)
        assert self.nval == other.nval
        basis = tuple(sorted(set(self.basis) | set(other.basis)))
        c = self.c + other.c
        Ga = self._broadcast_like(c)._with_basis(basis)
        Gb = other._broadcast_like(c)._with_basis(basis)
        r = self.r.expand(c.shape) + other.r.expand(c.shape)
        return PZ(c, Ga + Gb, r, basis, self.nval)

    __radd__ = __add__

    def __sub__(self, other) -> "PZ":
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def _broadcast_like(self, c_target) -> "PZ":
        if self.c.shape == c_target.shape:
            return self
        c = self.c.expand(c_target.shape)
        G = self.G.expand((self.ngens,) + c_target.shape)
        r = self.r.expand(c_target.shape)
        return PZ(c, G, r, self.basis, self.nval)

    def scale(self, a: float) -> "PZ":
        """Multiply by an exact scalar constant."""
        return PZ(self.c * a, self.G * a, self.r * abs(a), self.basis, self.nval)

    def __mul__(self, a):
        if isinstance(a, PZ):
            return pz_mul(self, a)
        return self.scale(a)

    __rmul__ = __mul__

    # -- reductions ------------------------------------------------------
    def reduce(self) -> "PZ":
        """Keep only k-dependent monomials; fold the rest into the radius
        (PZsparse.cu:352-368)."""
        keep = tuple(i for i, k in enumerate(self.basis) if _shape_degree(k) == 0)
        drop = tuple(i for i in range(self.ngens) if i not in keep)
        r = self.r
        if drop:
            r = r + self.G[_index(drop, self.c.device)].abs().sum(0)
        basis = tuple(self.basis[i] for i in keep)
        G = self.G[_index(keep, self.c.device)] if keep else self.c.new_zeros((0,) + self.c.shape)
        return PZ(self.c, G, r, basis, self.nval)

    def reduce_link(self):
        """Split a 3-vector link PZ into (k-only PZ, 3x6 independent
        generator matrix) as required by obstacle buffering
        (PZsparse.cu:370-402).

        Columns 0-2: the three link-shape generators (pure shape-variable
        monomials); columns 3-5: diag of the independent radius.  Mixed
        k x shape monomials are folded into the radius.
        """
        assert self.nval == 1 and self.val_shape == (3,)
        k_idx, shape_cols, sweep_idx = [], {}, []
        for i, key in enumerate(self.basis):
            sd = _shape_degree(key)
            if sd == 0:
                k_idx.append(i)
            elif sd == 1 and _k_degree(key) == 0 and len(key) == 1:
                shape_cols[key[0][0]] = i
            else:
                sweep_idx.append(i)
        dev = self.c.device
        r = self.r
        if sweep_idx:
            r = r + self.G[_index(tuple(sweep_idx), dev)].abs().sum(0)
        basis = tuple(self.basis[i] for i in k_idx)
        G = self.G[_index(tuple(k_idx), dev)] if k_idx else self.c.new_zeros((0,) + self.c.shape)
        pz_k = PZ(self.c, G, r, basis, 1)

        zero = self.c.new_zeros(self.c.shape)
        cols = [self.G[shape_cols[var]] if var in shape_cols else zero for var in _SHAPE_VARS]
        diag = torch.diag_embed(r.expand(self.c.shape))             # (..., 3, 3)
        gens = torch.cat([torch.stack(cols, dim=-1), diag], dim=-1)  # (..., 3, 6)
        return pz_k, gens

    def to_interval(self):
        """Conservative interval hull: c +/- (r + sum |G_i|)
        (PZsparse.cu:557-576)."""
        rad = self.r
        if self.ngens:
            rad = rad + self.G.abs().sum(0)
        return self.c - rad, self.c + rad

    # -- slicing ---------------------------------------------------------
    def monomials(self, k: torch.Tensor) -> torch.Tensor:
        """Evaluate the basis monomials at trajectory parameter k: (NG,)."""
        assert all(_shape_degree(key) == 0 for key in self.basis), (
            "call reduce()/reduce_link() before slicing"
        )
        return _monomials(self.basis, k)

    def slice(self, k: torch.Tensor):
        """Slice at concrete k: (center(k), radius)."""
        return _slice(self.c, self.G, self.r, self.monomials(k))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

# Levi-Civita tensor for cross products; its abs is the monotone majorant
_LEVI = np.zeros((3, 3, 3))
_LEVI[0, 1, 2] = _LEVI[1, 2, 0] = _LEVI[2, 0, 1] = 1.0
_LEVI[0, 2, 1] = _LEVI[1, 0, 2] = _LEVI[2, 1, 0] = -1.0
_ABS_LEVI = np.abs(_LEVI)


@functools.lru_cache(maxsize=None)
def _levi(absval: bool, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(_ABS_LEVI if absval else _LEVI, dtype=dtype, device=device)


class _ProdKind:
    """A bilinear value-product with vectorized generator-pair forms, so the
    NGa x NGb contraction is ONE batched op instead of NGa x NGb ops.

    ``mode``: 'mul' (elementwise, plain broadcasting), 'cross' (Levi-Civita
    einsum), or einsum subscripts for matmat/matvec/dot.
    """

    def __init__(self, s1: str = "", s2: str = "", so: str = "", mode: str = "ein"):
        self.s1, self.s2, self.so, self.mode = s1, s2, so, mode

    def _apply(self, p1: str, p2: str, po: str, x, y, absval: bool):
        if self.mode == "mul":
            # align value/batch dims from the right, keeping gen axes in front
            def pad(arr, n_gen, tgt):
                need = tgt - (arr.ndim - n_gen)
                if need > 0:
                    arr = arr.reshape(arr.shape[:n_gen] + (1,) * need + arr.shape[n_gen:])
                return arr

            tgt = max(x.ndim - len(p1), y.ndim - len(p2))
            if p1 and p2:  # pair: (g, ...) x (h, ...) -> (g, h, ...)
                return pad(x, 1, tgt)[:, None] * pad(y, 1, tgt)[None, :]
            return pad(x, len(p1), tgt) * pad(y, len(p2), tgt)
        if self.mode == "cross":
            E = _levi(absval, x.dtype, x.device)
            return torch.einsum(f"ijk,{p1}...j,{p2}...k->{po}...i", E, x, y)
        return torch.einsum(f"{p1}{self.s1},{p2}{self.s2}->{po}{self.so}", x, y)

    def plain(self, x, y):
        return self._apply("", "", "", x, y, False)

    def plain_abs(self, x, y):
        return self._apply("", "", "", x, y, True)

    def left(self, xG, y):  # (g, ...), (...) -> (g, ...)
        return self._apply("g", "", "g", xG, y, False)

    def right(self, x, yG):
        return self._apply("", "h", "h", x, yG, False)

    def pair(self, xG, yG):  # -> (g, h, ...)
        return self._apply("g", "h", "gh", xG, yG, False)


_KIND_MUL = _ProdKind(mode="mul")
_KIND_MATMAT = _ProdKind("...ab", "...bc", "...ac")
_KIND_MATVEC = _ProdKind("...ab", "...b", "...a")
_KIND_DOT = _ProdKind("...a", "...a", "...")
_KIND_CROSS = _ProdKind(mode="cross")


@functools.lru_cache(maxsize=None)
def _combine_plan(basis_a: tuple, basis_b: tuple, max_deg: int):
    """Host-side monomial bookkeeping of one product, done once per basis
    pair.  Kept pair products that land on the same output key are split
    into groups with distinct targets, so each scatter-add has unique
    indices (deterministic on the card) and the adds happen in the same
    order as the reference's sequential scatter."""
    NGb = len(basis_b)
    kept_pairs, swept_pairs, pair_keys = [], [], []
    for i, ka in enumerate(basis_a):
        for j, kb in enumerate(basis_b):
            kk = _mul_keys(ka, kb)
            if _keep(kk, max_deg):
                kept_pairs.append(i * NGb + j)
                pair_keys.append(kk)
            else:
                swept_pairs.append(i * NGb + j)
    basis = tuple(sorted(set(basis_a) | set(basis_b) | set(pair_keys)))
    pos = {k: s for s, k in enumerate(basis)}
    groups: list[tuple[list, list]] = []
    seen: dict[MonKey, int] = {}
    for p, kk in zip(kept_pairs, pair_keys):
        g = seen.get(kk, 0)
        seen[kk] = g + 1
        if g == len(groups):
            groups.append(([], []))
        groups[g][0].append(p)
        groups[g][1].append(pos[kk])
    return (
        basis,
        tuple(pos[k] for k in basis_a),
        tuple(pos[k] for k in basis_b),
        tuple((tuple(src), tuple(dst)) for src, dst in groups),
        tuple(swept_pairs),
    )


def _combine(a: PZ, b: PZ, kind: _ProdKind, nval_out: int, max_deg: int) -> PZ:
    """Sound product of two PZs under a bilinear value-product
    (`armour_tpu/ops/pz.py:_combine`, PZsparse.cu:864-994)."""
    c_out = kind.plain(a.c, b.c)
    NGa, NGb = a.ngens, b.ngens
    basis, slot_a, slot_b, pair_groups, swept_pairs = _combine_plan(a.basis, b.basis, max_deg)
    dev = c_out.device

    G_out = c_out.new_zeros((len(basis),) + c_out.shape)
    if NGa:
        G_out.index_add_(0, _index(slot_a, dev), kind.left(a.G, b.c).expand((NGa,) + c_out.shape))
    if NGb:
        G_out.index_add_(0, _index(slot_b, dev), kind.right(a.c, b.G).expand((NGb,) + c_out.shape))
    swept = None
    if NGa and NGb:
        P = kind.pair(a.G, b.G).reshape((NGa * NGb,) + c_out.shape)
        for src, dst in pair_groups:
            G_out.index_add_(0, _index(dst, dev), P[_index(src, dev)])
        if swept_pairs:
            swept = P[_index(swept_pairs, dev)].abs().sum(0)

    # radius: r_a x |b|, |a| x r_b, r_a x r_b  (PZsparse.cu:944-989)
    ra = a.r.expand(a.c.shape)
    rb = b.r.expand(b.c.shape)
    r_out = (
        kind.plain_abs(a.abs_sum(), rb)
        + kind.plain_abs(ra, b.abs_sum())
        + kind.plain_abs(ra, rb)
    )
    if swept is not None:
        r_out = r_out + swept
    return PZ(c_out, G_out, r_out.expand(c_out.shape), basis, nval_out)


def pz_mul(a: PZ, b: PZ, max_deg: int = DEFAULT_MAX_DEGREE) -> PZ:
    """Elementwise / scalar-broadcast product."""
    return _combine(a, b, _KIND_MUL, max(a.nval, b.nval), max_deg)


def pz_matmat(a: PZ, b: PZ, max_deg: int = DEFAULT_MAX_DEGREE) -> PZ:
    """(..., 3, 3) @ (..., 3, 3)."""
    assert a.nval == 2 and b.nval == 2
    return _combine(a, b, _KIND_MATMAT, 2, max_deg)


def pz_matvec(a: PZ, b: PZ, max_deg: int = DEFAULT_MAX_DEGREE) -> PZ:
    """(..., 3, 3) @ (..., 3)."""
    assert a.nval == 2 and b.nval == 1
    return _combine(a, b, _KIND_MATVEC, 1, max_deg)


def pz_cross(a: PZ, b: PZ, max_deg: int = DEFAULT_MAX_DEGREE) -> PZ:
    """cross((..., 3), (..., 3)) (PZsparse.cu:1134-1151)."""
    assert a.nval == 1 and b.nval == 1
    return _combine(a, b, _KIND_CROSS, 1, max_deg)


def pz_dot(a: PZ, b: PZ, max_deg: int = DEFAULT_MAX_DEGREE) -> PZ:
    """dot((..., 3), (..., 3)) -> scalar."""
    assert a.nval == 1 and b.nval == 1
    return _combine(a, b, _KIND_DOT, 0, max_deg)


def pz_stack(pzs: Sequence[PZ], axis: int = -1) -> PZ:
    """Stack scalar PZs into a vector PZ (PZsparse.cu:1087-1116)."""
    assert all(p.nval == pzs[0].nval for p in pzs)
    basis = tuple(sorted(set().union(*[set(p.basis) for p in pzs])))
    shape = torch.broadcast_shapes(*[p.c.shape for p in pzs])
    ref = pzs[0].c.new_zeros(shape)
    ax = axis if axis >= 0 else len(shape) + 1 + axis
    return PZ(
        torch.stack([p.c.expand(shape) for p in pzs], dim=ax),
        torch.stack([p._broadcast_like(ref)._with_basis(basis) for p in pzs], dim=ax + 1),
        torch.stack([p.r.expand(shape) for p in pzs], dim=ax),
        basis,
        pzs[0].nval + 1,
    )


def pz_component(p: PZ, idx) -> PZ:
    """Extract a component (e.g. one row of a vector PZ) -> lower-nval PZ."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    sl = (Ellipsis,) + idx
    return PZ(p.c[sl], p.G[sl], p.r[sl], p.basis, p.nval - len(idx))


def pz_set_component(p: PZ, idx, q: PZ) -> PZ:
    """Add a scalar PZ into one entry of a vector/matrix PZ
    (PZsparse.cu:1068-1085 ``addOneDimPZ``)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    basis = tuple(sorted(set(p.basis) | set(q.basis)))
    sl = (Ellipsis,) + idx
    c = p.c.clone()
    c[sl] = c[sl] + q.c
    G = p._with_basis(basis).clone()
    Gsl = (slice(None), Ellipsis) + idx
    G[Gsl] = G[Gsl] + q._with_basis(basis)
    r = p.r.clone()
    r[sl] = r[sl] + q.r
    return PZ(c, G, r, basis, p.nval)


def rot_from_cos_sin(cos_pz: PZ, sin_pz: PZ, axis: int, fixed_rot: np.ndarray) -> PZ:
    """Rotation-matrix PZ: fixed_rot @ R_axis(cos, sin).

    ``axis`` follows the reference convention: 1/2/3 = x/y/z, negative =
    reversed direction (sin negated).  Mirrors `PZsparse.cu:179-250`.
    """
    assert cos_pz.nval == 0 and sin_pz.nval == 0
    if axis < 0:
        sin_pz = -sin_pz
        axis = -axis
    a = axis - 1
    i1, i2 = [x for x in range(3) if x != a]

    def embed(cv, sv, signed: bool, diag_one: bool = False):
        """Place cos/sin values into the 3x3 axis-rotation pattern."""
        shape = torch.broadcast_shapes(cv.shape, sv.shape)
        cv = cv.expand(shape)
        sv = sv.expand(shape)
        z = cv.new_zeros(shape)
        M = [[z, z, z], [z, z, z], [z, z, z]]
        M[i1][i1] = cv
        M[i2][i2] = cv
        if diag_one:
            M[a][a] = cv.new_ones(shape)
        sgn = -1.0 if signed else 1.0
        # axis=2 (y) has the transposed sign pattern (PZsparse.cu:234-239)
        if a == 1:
            M[i1][i2] = sv
            M[i2][i1] = sgn * sv
        else:
            M[i1][i2] = sgn * sv
            M[i2][i1] = sv
        return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)

    c = embed(cos_pz.c, sin_pz.c, True, diag_one=True)

    keys, coeffs = [], []
    for i, key in enumerate(cos_pz.basis):
        keys.append(key)
        coeffs.append(embed(cos_pz.G[i], torch.zeros_like(cos_pz.G[i]), True))
    for i, key in enumerate(sin_pz.basis):
        keys.append(key)
        coeffs.append(embed(torch.zeros_like(sin_pz.G[i]), sin_pz.G[i], True))

    r = embed(cos_pz.r, sin_pz.r, False)

    R_axis = PZ.from_gens(c, keys, coeffs, r=r, nval=2)
    F = PZ.const(_like(fixed_rot, c), nval=2)
    return pz_matmat(F, R_axis)


def pz_zeros_vec(batch_shape, dtype=torch.float64, device=None) -> PZ:
    """The zero 3-vector PZ of ``batch_shape`` on ``device`` (default the
    card, `device.resolve_device`)."""
    z = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=resolve_device(device))
    return PZ(z, z.new_zeros((0,) + z.shape), torch.zeros_like(z), (), 1)


def pz_transpose(p: PZ) -> PZ:
    assert p.nval == 2
    return PZ(p.c.transpose(-1, -2), p.G.transpose(-1, -2), p.r.transpose(-1, -2), p.basis, 2)


# ---------------------------------------------------------------------------
# packed groups: what the NLP hot loop slices
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mono_plan(basis: tuple, device: torch.device):
    """(var, exp) of every factor of every monomial, padded with exponent-0
    factors to one width: two (NG, F) long tensors."""
    F = max(len(k) for k in basis)
    var = [[v for v, _ in k] + [0] * (F - len(k)) for k in basis]
    exp = [[e for _, e in k] + [0] * (F - len(k)) for k in basis]
    max_exp = max(max(row) for row in exp)
    return (torch.tensor(var, dtype=torch.long, device=device),
            torch.tensor(exp, dtype=torch.long, device=device), max_exp)


def _int_pow(x: torch.Tensor, e: torch.Tensor, max_exp: int) -> torch.Tensor:
    """x ** e for small non-negative integer exponents, by repeated
    products (x*x, as the reference's integer power computes it)."""
    out = torch.ones_like(x)
    p = torch.ones_like(x)
    for j in range(1, max_exp + 1):
        p = x if j == 1 else p * x
        out = torch.where(e == j, p, out)
    return out


def _monomials_with_jac(basis: tuple, K: torch.Tensor):
    """The monomials of ``basis`` at K (..., n) -> M (..., NG) and dM/dK
    (..., NG, n), the Jacobian derived analytically from the basis."""
    var, exp, max_exp = _mono_plan(basis, K.device)
    kv = K[..., var]                                    # (..., NG, F)
    fac = _int_pow(kv, exp, max_exp)
    dfac = exp.to(K.dtype) * _int_pow(kv, (exp - 1).clamp(min=0), max_exp)
    F = var.shape[1]
    M = fac[..., 0]
    for f in range(1, F):
        M = M * fac[..., f]
    dM = K.new_zeros(K.shape[:-1] + (len(basis), K.shape[-1]))
    for f in range(F):
        d = dfac[..., f]
        for f2 in range(F):
            if f2 != f:
                d = d * fac[..., f2]
        dM = dM.scatter_add(-1, var[:, f:f + 1].expand(d.shape + (1,)), d[..., None])
    return M, dM


def _monomials(basis: tuple, k: torch.Tensor) -> torch.Tensor:
    """The monomials of ``basis`` at one k (n,): (NG,)."""
    if not basis:
        return k.new_zeros((0,))
    var, exp, max_exp = _mono_plan(basis, k.device)
    return _int_pow(k[var], exp, max_exp).prod(-1)


def _slice(c, G, r, m):
    """(c + sum_g m_g G_g, r): a slice at the monomials m (NG,)."""
    if len(m):
        c = c + torch.tensordot(m, G, dims=1)
    return c, r


@dataclasses.dataclass(frozen=True)
class PackedPZ:
    """A group of PZs re-indexed onto one shared (union) monomial basis and
    stacked along a new group axis, so slicing the whole group at a
    concrete k is one tensor contraction.  This is what the NLP hot loop
    consumes.  ``c``/``r``: (B, *shape); ``G``: (NG, B, *shape)."""

    c: torch.Tensor
    G: torch.Tensor
    r: torch.Tensor
    basis: tuple

    def monomials_with_jac(self, K: torch.Tensor):
        """Monomials at K (..., n) -> M (..., NG) and dM/dK (..., NG, n),
        the Jacobian derived analytically from the (tiny) basis."""
        return _monomials_with_jac(self.basis, K)

    def monomials(self, k: torch.Tensor) -> torch.Tensor:
        """The monomials at one k (n,): (NG,)."""
        return _monomials(self.basis, k)

    def slice(self, k: torch.Tensor):
        """(center(k), radius) at one k (n,), the same k for every world."""
        return _slice(self.c, self.G, self.r, self.monomials(k))

    def slice_with_jac(self, k: torch.Tensor):
        """(center(k), radius, dcenter/dk (n, *c.shape)) at one k (n,):
        ``slice_with_jac_multi`` with k as the one start of every row."""
        c, r, dc = self.slice_with_jac_multi(k.expand(self.c.shape[0], 1, k.shape[0]))
        return c[:, 0], r, dc[:, 0].movedim(1, 0)

    def slice_with_jac_multi(self, K: torch.Tensor):
        """K (B, S, n) -> (centers (B, S, *shape), radius (B, *shape),
        dcenters (B, S, n, *shape))."""
        B, S, n = K.shape
        shape = self.c.shape[1:]
        if not len(self.basis):
            z = self.c[:, None].expand((B, S) + shape)
            return z, self.r, self.c.new_zeros((B, S, n) + shape)
        M, dM = self.monomials_with_jac(K)                  # (B,S,NG), (B,S,NG,n)
        G = self.G.reshape(self.G.shape[0], B, -1)          # (NG, B, X)
        c = self.c[:, None] + torch.einsum("bsg,gbx->bsx", M, G).reshape((B, S) + shape)
        dc = torch.einsum("bsgn,gbx->bsnx", dM, G).reshape((B, S, n) + shape)
        return c, self.r, dc


def pack_pzs(pzs: Sequence[PZ], axis: int = -1) -> PackedPZ:
    """Stack k-only PZs (same value shape) onto a union basis + group axis."""
    basis = tuple(sorted(set().union(*[set(p.basis) for p in pzs])))
    assert all(_shape_degree(key) == 0 for key in basis), "reduce() first"
    shape = torch.broadcast_shapes(*[p.c.shape for p in pzs])
    ref = pzs[0].c.new_zeros(shape)
    ax = axis if axis >= 0 else len(shape) + 1 + axis
    c = torch.stack([p.c.expand(shape) for p in pzs], dim=ax)
    r = torch.stack([p.r.expand(shape) for p in pzs], dim=ax)
    G = torch.stack([p._broadcast_like(ref)._with_basis(basis) for p in pzs], dim=ax + 1)
    return PackedPZ(c, G, r, basis)
