"""Batched box-constrained NLP solvers: augmented Lagrangian + projected
Gauss-Newton, all worlds (and starts) in lockstep.

Port of `armour_tpu/planner/nlp.py` (see its docstrings for the method):
``solve_box_alm_multi``, the planner's start-batched solver, and
``solve_box_alm``, the single-start solver.  The fixed-length ``lax.scan`` loops become Python loops;
``jax.grad``/``jax.hessian``/``jax.jacfwd`` become ``torch.func``.  Every
tensor carries (B worlds, S starts) in front; the constraint Jacobian is
kept TRANSPOSED, (B, S, n, m), which is the layout the collision kernel
writes, so the hot loop never transposes it.

On a card, ``solve_box_alm_multi``'s Gauss-Newton iteration is captured
once per call as a CUDA graph and replayed (`utils/graphs.py`), the
counterpart of the JAX package's compiled ``lax.scan``; a solve kept across
calls (``keep``) keeps that graph and two more, the first bank pass and the
outer update.  A caller that
knows its cost is a sum of per-coordinate terms, or a constraint block
elementwise over the coordinates, takes their exact derivatives from one
all-ones tangent (``separable_cost_derivatives``,
``diagonal_jacobian_t``) instead of n.

Problem form:  min f(k)  s.t.  c(k) <= 0 (one-sided),  k in [-1, 1]^n.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, jvp, vmap

from armour_tpu_torch.ops.linalg import spd_solve_small
from armour_tpu_torch.utils.graphs import release, stepper


class ALMResult(NamedTuple):
    """Shapes for ``solve_box_alm_multi``; ``solve_box_alm`` has no start
    axis S and leaves the last three fields None."""

    k: torch.Tensor              # (B, S, n) final iterates
    max_violation: torch.Tensor  # (B, S)
    cost: torch.Tensor           # (B, S)
    k_feas: torch.Tensor         # (B, S, n) lowest-cost STRICTLY feasible iterate seen
    found_feas: torch.Tensor     # (B, S) bool: k_feas is valid (else == the start)
    c: torch.Tensor = None       # (B, S, m) exact constraint values at k
    c0: torch.Tensor = None      # (B, S, m) exact constraint values at the starts
    v_feas: torch.Tensor = None  # (B, S) max constraint value at k_feas (<= 0)


def jacobian_t(fn: Callable, K: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of ``fn: (..., n) -> (..., m)``, a function
    that is independent across the leading dims, returned transposed as
    (..., n, m): one tangent per coordinate, as ``jax.jacfwd`` pushes them."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    tangents = eye.reshape((n,) + (1,) * (K.ndim - 1) + (n,)).expand((n,) + K.shape)
    jac = vmap(lambda v: jvp(fn, (K,), (v,))[1])(tangents)   # (n, ..., m)
    return jac.movedim(0, -2)


def cost_derivatives(f_fn: Callable, K: torch.Tensor):
    """Gradient (..., n) and Hessian (..., n, n) of a cost ``f_fn: (..., n)
    -> (...)`` that is independent across the leading dims (forward over
    reverse, as ``jax.hessian``)."""
    g_fn = grad(lambda k: f_fn(k).sum())
    return g_fn(K), jacobian_t(g_fn, K)


def diagonal_jacobian_t(fn: Callable, K: torch.Tensor) -> torch.Tensor:
    """``jacobian_t(fn, K)`` for an ``fn: (..., n) -> (..., b*n)`` whose
    every block of n outputs is elementwise over the n inputs (output
    ``[..., b*n + j]`` depends on ``K[..., j]`` alone): one all-ones tangent
    carries every nonzero entry, and entry ``[..., i, b*n + j]`` is
    ``delta_ij * d[..., b*n + j]``.  The tangent of output j meets only the
    tangent of input j, so the entries are those of ``jacobian_t``, bit for
    bit (where ``jacobian_t`` writes an off-diagonal zero as -0.0, this
    writes 0.0).  The caller vouches for the structure: nothing here checks it."""
    n = K.shape[-1]
    d = jvp(fn, (K,), (torch.ones_like(K),))[1]                  # (..., b*n)
    blocks = torch.diag_embed(d.unflatten(-1, (-1, n)))           # (..., b, n, n)
    return blocks.transpose(-3, -2).flatten(-2)                   # (..., n, b*n)


def separable_cost_derivatives(f_fn: Callable, K: torch.Tensor):
    """``cost_derivatives`` for a cost that is a sum of per-coordinate terms
    over the last axis: its Hessian is diagonal, and one all-ones tangent
    through the gradient gives it (the entries of ``cost_derivatives``,
    bit for bit up to the sign of a zero, as in ``diagonal_jacobian_t``)."""
    g_fn = grad(lambda k: f_fn(k).sum())
    g, h = jvp(g_fn, (K,), (torch.ones_like(K),))
    return g, torch.diag_embed(h)


def solve_box_alm(
    f_fn: Callable,
    c_fn: Callable,
    k0: torch.Tensor,
    outer_iters: int = 14,
    inner_iters: int = 14,
    mu0: float = 10.0,
    mu_growth: float = 4.0,
    mu_max: float = 1e6,
    newton_reg: float = 1e-8,
    ls_steps: int = 4,
    cj_fn: Callable | None = None,
) -> ALMResult:
    """Single-start ALM over the leading dims of ``k0`` (..., n), usually
    the worlds (B, n); the JAX package's version takes one problem and is
    vmapped by its caller.

    ``f_fn``: k (..., n) -> (...) and ``c_fn``: k (..., n) -> (..., m),
    both independent across the leading dims.

    ``cj_fn``: optional k -> (c (..., m), Jt (..., n, m)) returning values
    AND the TRANSPOSED Jacobian in one fused pass.  When given, each
    Gauss-Newton iteration makes exactly ONE pass over the constraints and
    the line search runs on the linearized constraint model.  Without it,
    forward-mode tangents and an exact-merit line search are used.
    """
    n = k0.shape[-1]
    dtype, dev = k0.dtype, k0.device
    lead = k0.shape[:-1]
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    shrink = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)

    def penalty(c, lam, mu):  # (..., m), (..., m), (...) -> (...)
        a = torch.clamp(lam + mu[..., None] * c, min=0.0)
        return torch.sum(a * a - lam * lam, dim=-1) / (2.0 * mu)

    def newton_dir(k, c, Jt, lam, mu):
        fgrad, fhess = cost_derivatives(f_fn, k)
        a = torch.clamp(lam + mu[..., None] * c, min=0.0)
        grad_al = fgrad + torch.einsum("...nm,...m->...n", Jt, a)
        active = (a > 0.0).to(dtype)
        H = mu[..., None, None] * torch.matmul(Jt * active[..., None, :], Jt.transpose(-1, -2))
        H = H + fhess + newton_reg * eye_n
        return -spd_solve_small(H + 1e-10 * eye_n, grad_al)

    def pick(values, phis):
        """values (A, ..., x), phis (A, ...) -> the value with the least phi."""
        best = torch.argmin(phis, dim=0)
        idx = best[None, ..., None].expand((1,) + values.shape[1:])
        return torch.gather(values, 0, idx)[0], torch.gather(phis, 0, best[None])[0]

    # cj route: ONE constraint pass per inner iteration, made at the
    # line-search CANDIDATE; (c, Jt) at the current iterate are carried and
    # acceptance is decided on the EXACT merit
    def inner_step_cj(k, c, Jt, lam, mu, scale):
        dk = newton_dir(k, c, Jt, lam, mu)
        phi0 = f_fn(k) + penalty(c, lam, mu)
        alphas = scale[None] * shrink.reshape((ls_steps,) + (1,) * len(lead))
        k_new = torch.clamp(k[None] + alphas[..., None] * dk[None], -1.0, 1.0)   # (A, ..., n)
        c_lin = c[None] + torch.einsum("...nm,a...n->a...m", Jt, k_new - k[None])
        phis = f_fn(k_new) + penalty(c_lin, lam[None], mu[None])
        k_cand, _ = pick(k_new, phis)
        c_cand, J_cand = cj_fn(k_cand)
        accept = (f_fn(k_cand) + penalty(c_cand, lam, mu)) < phi0
        scale = torch.where(accept, 1.0, torch.clamp(scale * 0.5 ** ls_steps, min=1e-6))
        return (torch.where(accept[..., None], k_cand, k),
                torch.where(accept[..., None], c_cand, c),
                torch.where(accept[..., None, None], J_cand, Jt),
                scale)

    def inner_step(k, lam, mu):
        c, Jt = c_fn(k), jacobian_t(c_fn, k)
        dk = newton_dir(k, c, Jt, lam, mu)
        phi0 = f_fn(k) + penalty(c, lam, mu)
        # backtracking line search on the EXACT merit with box projection,
        # one step length at a time (the constraint pipeline's peak memory)
        k_new = torch.stack([torch.clamp(k + a * dk, -1.0, 1.0) for a in shrink])
        phis = torch.stack([f_fn(kn) + penalty(c_fn(kn), lam, mu) for kn in k_new])
        k_best, phi_best = pick(k_new, phis)
        return torch.where((phi_best < phi0)[..., None], k_best, k)

    k = k0
    m = c_fn(k0).shape[-1]
    lam = torch.zeros(lead + (m,), dtype=dtype, device=dev)
    mu = torch.full(lead, mu0, dtype=dtype, device=dev)
    viol = torch.full(lead, torch.inf, dtype=dtype, device=dev)
    k_feas = k0
    f_feas = torch.full(lead, torch.inf, dtype=dtype, device=dev)
    found = torch.zeros(lead, dtype=torch.bool, device=dev)
    for _ in range(outer_iters):
        if cj_fn is not None:
            c, Jt = cj_fn(k)
            scale = torch.ones(lead, dtype=dtype, device=dev)
            for _ in range(inner_iters):
                k, c, Jt, scale = inner_step_cj(k, c, Jt, lam, mu, scale)
        else:
            for _ in range(inner_iters):
                k = inner_step(k, lam, mu)
            c = c_fn(k)
        prev_viol, viol = viol, torch.amax(torch.clamp(c, min=0.0), dim=-1)
        f_now = f_fn(k)
        upd = (torch.amax(c, dim=-1) <= 0.0) & (f_now < f_feas)
        k_feas = torch.where(upd[..., None], k, k_feas)
        f_feas = torch.where(upd, f_now, f_feas)
        found = found | upd
        lam = torch.clamp(lam + mu[..., None] * c, min=0.0)
        mu = torch.where(viol > 0.25 * prev_viol, torch.clamp(mu * mu_growth, max=mu_max), mu)
    return ALMResult(k=k, max_violation=viol, cost=f_fn(k), k_feas=k_feas, found_feas=found)


def solve_box_alm_multi(
    f_fn: Callable,
    cj_fn_multi: Callable,
    K0: torch.Tensor,
    outer_iters: int = 8,
    inner_iters: int = 8,
    mu0: float = 10.0,
    mu_growth: float = 4.0,
    mu_max: float = 1e6,
    newton_reg: float = 1e-8,
    ls_steps: int = 4,
    separable_cost: bool = False,
    eager: bool = False,
    keep: dict | None = None,
) -> ALMResult:
    """Start-batched ALM: all S starts of all B worlds advance in lockstep,
    so the constraint bank is streamed ONCE per Gauss-Newton iteration.

    ``f_fn``: K (..., n) -> (...), independent across leading dims.
    ``cj_fn_multi``: K (B, S, n) -> (c (B, S, m), Jt (B, S, n, m)).
    ``separable_cost``: the caller knows that ``f_fn`` is a sum of
    per-coordinate terms, so its Hessian is diagonal
    (``separable_cost_derivatives``); the solver does not guess.

    The solve is three steps over buffers that they update in place: the
    first bank pass at the starts (which also resets every buffer), the
    Gauss-Newton iteration (``outer_iters * inner_iters`` times) and the
    outer update (``outer_iters`` times).  On a card the iteration is one
    CUDA graph, captured at the first iteration of this call and replayed
    for the others: ``f_fn`` and ``cj_fn_multi`` must then neither
    synchronise with the host nor make tensors from host data, and the
    graph reads whatever they close over by address, so it is kept beyond
    the call only through ``keep``.  ``eager=True`` runs it op by op
    instead, to hold the graph against it or to record it inside another
    capture; the CPU always runs op by op.

    ``keep``: a dict that holds the state and the steps across calls of one
    shape, each of the three steps a graph of its own on a card.  An empty
    one is filled by this call; with a filled one the first step resets the
    state, so that the graphs the first call captured are replayed by every
    later one.  The caller vouches that ``K0`` is the same tensor in every
    such call, and that ``f_fn`` and ``cj_fn_multi`` read the same tensors.
    The result's tensors are then the kept buffers: the next call
    overwrites them.
    """
    B, S, n = K0.shape
    dtype, dev = K0.dtype, K0.device
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    shrink = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)

    def penalty(c, lam, mu):  # (..., m), (..., m), (...) -> (...)
        a = torch.clamp(lam + mu[..., None] * c, min=0.0)
        return torch.sum(a * a - lam * lam, dim=-1) / (2.0 * mu)

    # Each inner iteration makes exactly ONE bank pass, at the line-search
    # CANDIDATE; (c, J) at the current iterate are carried, the model line
    # search picks the candidate, and acceptance is decided on the EXACT
    # augmented-Lagrangian merit at that candidate.
    derivatives = separable_cost_derivatives if separable_cost else cost_derivatives

    def inner_step(K, c, Jt, lam, mu, scale):
        a = torch.clamp(lam + mu[..., None] * c, min=0.0)          # (B, S, m)
        fgrad, fhess = derivatives(f_fn, K)
        grad_al = fgrad + torch.einsum("bsnm,bsm->bsn", Jt, a)
        active = (a > 0.0).to(dtype)
        H = mu[..., None, None] * torch.matmul(Jt * active[:, :, None, :], Jt.transpose(-1, -2))
        H = H + fhess + (newton_reg + 1e-10) * eye_n
        dk = -spd_solve_small(H, grad_al)
        phi0 = f_fn(K) + penalty(c, lam, mu)

        # step length on the linearized constraint model (exact f); `scale`
        # continues the backtracking sequence across iterations
        alphas = scale[None] * shrink[:, None, None]              # (A, B, S)
        K_new = torch.clamp(K[None] + alphas[..., None] * dk[None], -1.0, 1.0)
        dK = K_new - K[None]                                      # (A, B, S, n)
        c_lin = c[None] + torch.einsum("bsnm,absn->absm", Jt, dK)
        a_lin = torch.clamp(lam[None] + mu[None, ..., None] * c_lin, min=0.0)
        pen = torch.sum(a_lin * a_lin - (lam * lam)[None], dim=-1) / (2.0 * mu)[None]
        phis = f_fn(K_new) + pen                                  # (A, B, S)
        best = torch.argmin(phis, dim=0)                          # (B, S)
        K_cand = torch.gather(K_new, 0, best[None, ..., None].expand(1, B, S, n))[0]

        c_cand, J_cand = cj_fn_multi(K_cand)                      # THE bank pass
        phi_cand = f_fn(K_cand) + penalty(c_cand, lam, mu)
        accept = phi_cand < phi0                                  # exact decrease
        scale = torch.where(accept, 1.0, torch.clamp(scale * 0.5 ** ls_steps, min=1e-6))
        return (torch.where(accept[..., None], K_cand, K),
                torch.where(accept[..., None], c_cand, c),
                torch.where(accept[..., None, None], J_cand, Jt),
                scale)

    # the solve's state, in buffers that the steps update in place (the
    # graphs' inputs and outputs); the first step makes them on its first,
    # op-by-op run, once the constraint count m is known
    st = keep.get("state") if keep else None
    if st is None:
        st = {}
        names = ("K", "c", "Jt", "lam", "mu", "scale")

        def first():
            """The first bank pass at the starts, and every buffer reset."""
            c0, J0 = cj_fn_multi(K0)
            if not st:
                ftype = dict(dtype=dtype, device=dev)
                st.update(K=torch.empty_like(K0), c0=torch.empty_like(c0), c=torch.empty_like(c0),
                          Jt=torch.empty_like(J0), lam=torch.empty(c0.shape, **ftype),
                          K_feas=torch.empty_like(K0),
                          **{k: torch.empty((B, S), **ftype) for k in
                             ("mu", "scale", "prev_viol", "f_feas", "v_feas", "cost")},
                          found=torch.empty((B, S), dtype=torch.bool, device=dev))
            for k, new in (("K", K0), ("c0", c0), ("c", c0), ("Jt", J0), ("K_feas", K0)):
                st[k].copy_(new)
            st["lam"].zero_()
            st["mu"].fill_(mu0)
            st["scale"].fill_(1.0)
            for k in ("prev_viol", "f_feas", "v_feas"):
                st[k].fill_(torch.inf)
            st["found"].zero_()

        def step():
            """One Gauss-Newton iteration."""
            state = [st[k] for k in names]
            for buf, new in zip(state[:3] + state[-1:], inner_step(*state)):
                buf.copy_(new)

        def outer():
            """The outer update: the incumbents and the multipliers."""
            K, c, lam, mu = st["K"], st["c"], st["lam"], st["mu"]
            # c is exact at K (carried from the accepted candidate's pass)
            viol = torch.amax(torch.clamp(c, min=0.0), dim=-1)
            f_now = f_fn(K)
            c_max = torch.amax(c, dim=-1)
            upd = (c_max <= 0.0) & (f_now < st["f_feas"])
            st["K_feas"].copy_(torch.where(upd[..., None], K, st["K_feas"]))
            st["f_feas"].copy_(torch.where(upd, f_now, st["f_feas"]))
            st["v_feas"].copy_(torch.where(upd, c_max, st["v_feas"]))
            st["found"].copy_(st["found"] | upd)
            lam.copy_(torch.clamp(lam + mu[..., None] * c, min=0.0))
            mu.copy_(torch.where(viol > 0.25 * st["prev_viol"],
                                 torch.clamp(mu * mu_growth, max=mu_max), mu))
            st["prev_viol"].copy_(viol)
            st["cost"].copy_(f_now)          # K moves no more after the last update
            st["scale"].fill_(1.0)

        if keep is None:
            steps = (first, stepper(step, dev, eager), outer)
        else:
            steps = tuple(stepper(f, dev, eager) for f in (first, step, outer))
            keep.update(state=st, K0=K0, steps=steps)
    else:
        steps = keep["steps"]
        assert K0 is keep["K0"], "a kept solve reads the starts of its first call"
    run_first, iterate, run_outer = steps
    run_first()
    for _ in range(outer_iters):
        for _ in range(inner_iters):
            iterate()
        run_outer()
    if keep is None:
        release(iterate)
    return ALMResult(k=st["K"], max_violation=st["prev_viol"],
                     cost=st["cost"] if outer_iters else f_fn(st["K"]), k_feas=st["K_feas"],
                     found_feas=st["found"], c=st["c"], c0=st["c0"], v_feas=st["v_feas"])
