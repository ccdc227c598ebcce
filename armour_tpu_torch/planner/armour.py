"""The ARMOUR planner: reachable sets -> constraints -> batched NLP.

Port of `armour_tpu/planner/armour.py`: the production mode
(``traj_type="bernstein"``, hard-max collision) and the optional modes
``traj_type="orig"`` (ARMTD comparison), smooth collision
(``cfg.smooth_collision_tau > 0``), grasp constraints and the
self-intersection block of the legacy rotatotope planners
(`planner/rotatotope.py`).  The JAX package maps the build over worlds with
``lax.map`` and vmaps the solve; here the world axis B is a leading
dimension of every tensor, and a plan is one pass over the batch:

    build_probs: Bezier JRS -> PZ-FK/RNEA -> whole-FRS obstacle culling
                 -> compaction -> bucketed hyperplane bank
    solve:       multi-start ALM (one collision-kernel launch per
                 Gauss-Newton iteration) -> fused strict re-verification;
                 in smooth mode the collision block is plain tensor code and
                 the explicit verification pool makes the one kernel launch

The JAX package compiles these once per shape; here every plan runs
through a ``PlanProgram`` kept per (B, bucket), CUDA graphs on a card
(``plan``, ``plan_batch``, ``run_program``), and ``eager=True`` runs the
same stages op by op.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import (
    BufferedHyperplanes,
    ObstacleSet,
    buffer_obstacles,
    collision_constraints_with_jac_multi,
    collision_values_multi,
    smooth_collision_constraints_with_jac,
)
from armour_tpu_torch.config import GraspConfig, PlannerConfig
from armour_tpu_torch.device import const, resolve_device
from armour_tpu_torch.dynamics.pz_rnea import build_reachable_sets
from armour_tpu_torch.jrs.armtd import (
    armtd_position_extrema,
    armtd_ref,
    armtd_velocity_extrema,
    make_armtd_jrs,
)
from armour_tpu_torch.jrs.bezier import (
    joint_position_extrema,
    joint_velocity_extrema,
    make_bezier_jrs,
    q_des_fn,
)
from armour_tpu_torch.ops.pz import PackedPZ, pack_pzs
from armour_tpu_torch.planner.nlp import diagonal_jacobian_t, solve_box_alm_multi
from armour_tpu_torch.planner.rotatotope import (
    build_self_intersection,
    self_intersection_pairs,
    self_intersection_values_multi,
    self_intersection_with_jac_multi,
)
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.utils.graphs import ProgramCache, keep_into, release, stepper, tree_map


def wrap_to_pi(x):
    """(NLPclass.cu:6-15), branch-free."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


class PlanResult(NamedTuple):
    k: torch.Tensor              # (B, nf) in [-1,1]; NaN row if infeasible
    feasible: torch.Tensor       # (B,) bool
    cost: torch.Tensor           # (B,) final cost (unscaled by COST_SCALE)
    max_violation: torch.Tensor  # (B,)
    torque_radius: torch.Tensor  # (B, T, nf)


class NLPFunctions(NamedTuple):
    """The NLP's closures over one built problem (``nlp_functions``)."""

    f: Callable        # K (B, S, n) -> cost (B, S)
    limits: Callable   # K (B, S, n) -> the state-limit block (B, S, 8 n)
    cj: Callable       # K (B, S, n) -> (c (B, S, m), Jt (B, S, n, m))


class ProblemData(NamedTuple):
    """Built reachable-set/constraint data for B planning problems, the
    output of the build phase, consumed by the solver."""

    links: PackedPZ              # centers (B, T, L, 3)
    u: PackedPZ | None           # nominal torques (B, T, nf), None without input constraints
    grasp: PackedPZ | None       # contact constraints (B, T, 3), None without a grasp
    hp: BufferedHyperplanes | None
    t_rad: torch.Tensor          # (B, T, nf)
    q0: torch.Tensor             # (B, nf)
    qd0: torch.Tensor
    Tqd0: torch.Tensor
    TTqdd0: torch.Tensor
    k_range: torch.Tensor        # (nf,), or (B, nf) where it depends on the world ('orig')
    si_diff: PackedPZ | None = None     # link-pair differences (B, T, P, 3), None without SI
    si_rad: torch.Tensor | None = None  # (B, T, P, 3) pair separation radii


def gather_obstacles(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather a per-shard collision block (..., O_shard, T) over the
    ranks of ``group`` and join the shards along the obstacle axis (-2),
    in rank order: the unsharded block's layout (the JAX package gathers
    onto a new leading axis instead, `armour.py:437-439`, so its rows come
    in another order).  Counts its calls in ``gather_obstacles.calls``."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    gather_obstacles.calls += 1
    return torch.cat(parts, dim=-2)


gather_obstacles.calls = 0


def broadcast_starts(k_rand: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``k_rand`` in place with the starts of the first rank of
    ``group`` and return it: every rank of a cp group must iterate on the
    same starts, or the gathered constraint vector would mix iterates."""
    import torch.distributed as dist

    dist.broadcast(k_rand, src=dist.get_global_rank(group, 0), group=group)
    return k_rand


def obstacle_bucket(masks) -> int:
    """Smallest obstacle capacity (a multiple of 8) covering every live
    slot of ``masks`` (`armour.py:213-228`): the bank, the solver's
    dominant memory stream, is sized by it."""
    m = masks.cpu().numpy() if isinstance(masks, torch.Tensor) else np.asarray(masks)
    live = m.any(axis=tuple(range(m.ndim - 1)))
    need = int(np.nonzero(live)[0].max() + 1) if live.any() else 1
    return min(m.shape[-1], max(8, -(-need // 8) * 8))


def cull_order(keep: np.ndarray):
    """(order (B, O), bucket) of a host keep mask: the STABLE order that
    moves each world's kept obstacles to the front, and the bucket that
    covers them (`armour.py:180-189`)."""
    order = np.argsort(~keep, axis=1, kind="stable")
    return order, obstacle_bucket(np.take_along_axis(keep, order, axis=1))


def compact(zonos, keep, order, bucket: int):
    """The first ``bucket`` obstacles of ``order`` (B, O) on the device:
    (zonos (B, bucket, 4, 3), masks (B, bucket)) from zonos (B, O, 4, 3)
    and the keep mask (B, O)."""
    idx = order[:, :bucket]
    return (torch.gather(zonos, 1, idx[:, :, None, None].expand(-1, -1, *zonos.shape[2:])),
            torch.gather(keep, 1, idx))


@dataclasses.dataclass
class ArmourPlanner:
    """Holds one planner configuration on one device.

    ``plan_batch(q0, qd0, qdd0, q_des, zonos, masks)`` plans B worlds at
    once; ``plan(q0, qd0, qdd0, q_des, obstacles)`` plans one.  Obstacles
    are padded to ``cfg.max_obstacles``.  ``device`` defaults to the card;
    without one it raises unless ``device="cpu"`` is passed.

    ``traj_type="orig"`` is the ARMTD comparison mode: constant-acceleration
    trajectories, no torque constraints, no tracking-error padding.
    ``grasp`` adds the contact constraints of a carried object.
    ``self_intersection`` adds the separation constraints of non-adjacent
    links: ``True`` for the home-separated pairs of
    ``self_intersection_pairs``, a list of (i, j) for those pairs,
    ``False`` or ``[]`` for none.
    """

    spec: RobotSpec
    cfg: PlannerConfig
    dtype: torch.dtype = torch.float64
    device: object = None
    traj_type: str = "bernstein"
    grasp: GraspConfig | None = None
    self_intersection: object = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.traj_type not in ("bernstein", "orig"):
            raise ValueError(f"unknown traj_type {self.traj_type!r}")
        if self.self_intersection is True:
            self._si_pairs = self_intersection_pairs(self.spec)
        elif self.self_intersection:
            self._si_pairs = list(self.self_intersection)
        else:
            self._si_pairs = []
        self._armtd = self.traj_type == "orig"
        if self._armtd and self.grasp is not None:
            raise ValueError("grasp constraints need the Bezier reachable sets; "
                             "traj_type='orig' has no velocity/acceleration sets")
        # ARMTD mode has no torque constraints (`armour.py:274-276`)
        self._cfg = (dataclasses.replace(self.cfg, input_constraints=False) if self._armtd
                     else self.cfg)
        spec = self.spec
        # the relaxed state acceptance threshold is only sound while it
        # stays well inside the tracking-error padding the limits carry
        if not self._armtd and not self.cfg.state_violation_threshold < 0.1 * min(spec.qe, spec.qde):
            raise ValueError(
                f"state_violation_threshold={self.cfg.state_violation_threshold} is "
                f"not << tracking-error padding qe={spec.qe}, qde={spec.qde}")

    # -- helpers ----------------------------------------------------------
    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype or self.dtype, device=self.device)

    def _const(self, x, dtype=None) -> torch.Tensor:
        """A constant of the robot or the configuration (`device.const`)."""
        return const(x, dtype or self.dtype, self.device)

    # -- build ------------------------------------------------------------
    def reachable_sets(self, q0, qd0, qdd0):
        """Obstacle-independent phase (`armour.py:264-316`): JRS ->
        PZ-FK/RNEA -> packed slicing tensors.  Returns (ProblemData with
        hp=None, link_indep_gens (B,T,L,3,6), aabb_c, aabb_r (B,T,L,3)):
        the AABBs are the interval hulls of the link-center sets over ALL k
        plus the link-shape radii, for the whole-FRS culling."""
        cfg = self._cfg
        q0, qd0, qdd0 = self._t(q0), self._t(qd0), self._t(qdd0)
        if self._armtd:
            jrs = make_armtd_jrs(self.spec, cfg, q0, qd0)
            Tqd0, TTqdd0 = torch.zeros_like(q0), torch.zeros_like(q0)
        else:
            jrs = make_bezier_jrs(self.spec, cfg, q0, qd0, qdd0)
            Tqd0, TTqdd0 = jrs.Tqd0, jrs.TTqdd0
        rs = build_reachable_sets(self.spec, cfg, jrs, grasp=self.grasp)
        si_diff = si_rad = None
        if self._si_pairs:
            si_diff, si_rad = build_self_intersection(rs.link_pz, rs.link_indep_gens, self._si_pairs)
        links = pack_pzs(rs.link_pz, axis=2)
        aabb_c = links.c
        aabb_r = links.r + rs.link_indep_gens.abs().sum(-1)
        if len(links.basis):
            aabb_r = aabb_r + links.G.abs().sum(0)
        prob = ProblemData(
            links=links,
            u=pack_pzs(rs.u_nom, axis=-1) if cfg.input_constraints else None,
            grasp=pack_pzs(rs.grasp_cons, axis=-1) if rs.grasp_cons else None,
            hp=None,
            t_rad=rs.torque_radius,
            q0=q0, qd0=qd0, Tqd0=Tqd0, TTqdd0=TTqdd0,
            k_range=jrs.k_range,
            si_diff=si_diff, si_rad=si_rad,
        )
        return prob, rs.link_indep_gens, aabb_c, aabb_r

    def cull_keep(self, aabb_c, aabb_r, zonos, masks) -> torch.Tensor:
        """(B, O) bool: False only when the obstacle is PROVABLY separated
        from the whole-FRS link hulls for all (t, link) (`armour.py:191-211`)."""
        margin = self.cfg.collision_numeric_slack + 1e-3
        obs_c = zonos[:, :, 0]                                  # (B, O, 3)
        obs_r = zonos[:, :, 1:].abs().sum(2)                    # (B, O, 3)
        separated = None
        for i in range(3):  # per axis, to avoid a (B,T,L,O,3) temporary
            dc = (aabb_c[:, :, :, None, i] - obs_c[:, None, None, :, i]).abs()
            s_i = dc - aabb_r[:, :, :, None, i] - obs_r[:, None, None, :, i]
            sep_i = s_i > margin
            separated = sep_i if separated is None else (separated | sep_i)
        keep = ~separated.flatten(1, 2).all(dim=1)
        return keep & masks

    def buffer(self, link_indep_gens, zonos, masks) -> BufferedHyperplanes:
        """Hyperplane-bank phase (`CollisionChecking.cu:136-228`)."""
        return buffer_obstacles(
            link_indep_gens, ObstacleSet(zonos, masks),
            slack=self.cfg.collision_numeric_slack,
            store_bf16=self.cfg.collision_bank_bf16,
        )

    def build_probs(self, q0, qd0, qdd0, zonos, masks, cull: bool | None = None) -> ProblemData:
        """Batched build: reachable sets -> whole-FRS obstacle culling ->
        compaction -> bucketed hyperplane bank (`armour.py:151-189`), op by
        op (the kept programs run the same stages as graphs, ``run_program``).

        Culling runs when the batch is above the minimum bucket: one
        device->host trip (the keep mask), then a STABLE compaction of the
        kept obstacles to the front (the bank's obstacle order decides
        argmax ties)."""
        zonos = self._t(zonos)
        masks = self._t(masks, torch.bool)
        b0 = obstacle_bucket(masks)
        prob, link_gens, aabb_c, aabb_r = self.reachable_sets(q0, qd0, qdd0)
        cull = self.cfg.obstacle_culling if cull is None else cull
        if not cull or b0 <= 8:
            hp = self.buffer(link_gens, zonos[:, :b0], masks[:, :b0])
            return prob._replace(hp=hp)
        keep = self.cull_keep(aabb_c, aabb_r, zonos, masks)
        order, b = cull_order(keep.cpu().numpy())
        order = torch.as_tensor(order, device=self.device)
        return prob._replace(hp=self.buffer(link_gens, *compact(zonos, keep, order, b)))

    # -- solve ------------------------------------------------------------
    def random_starts(self, B: int, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, max(S-2, 1), nf) interior random starts, uniform in
        [-0.6, 0.6) (`armour.py:466-475`).  The JAX package draws them from
        ``jax.random``; the port from an explicit ``torch.Generator``
        (seeded 0 unless given), so the two differ: tests inject the JAX
        starts through ``k_rand``."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        n_rand = max(self.cfg.nlp_num_starts - 2, 1)
        u = torch.rand((B, n_rand, self.spec.n_factors), generator=generator,
                       dtype=self.dtype, device=self.device)
        return u * 1.2 - 0.6

    def nlp_functions(self, prob: ProblemData, q_des, collision_group=None) -> NLPFunctions:
        """The NLP's closures over a built problem (`armour.py:347-440`):
        the cost, the state-limit block and the fused constraint pass.  The
        cost is a sum of per-joint terms and the state-limit block is
        elementwise over joints, so their exact derivatives come from one
        all-ones tangent (`planner/nlp.py`).  ``collision_group``: see
        ``solve``."""
        spec, cfg, dev = self.spec, self._cfg, self.device
        armtd = self._armtd
        nf = spec.n_factors
        B = prob.q0.shape[0]
        q_des = self._t(q_des)
        t_lim = self._const(spec.torque_limits)
        # ARMTD mode carries no tracking-error sets (`armour.py:362-363`)
        qe = 0.0 if armtd else spec.qe
        qde = 0.0 if armtd else spec.qde
        pos_lb = self._const(spec.pos_limits_lb + qe)
        pos_ub = self._const(spec.pos_limits_ub - qe)
        vel_lb = self._const(-spec.speed_limits + qde)
        vel_ub = self._const(spec.speed_limits - qde)
        cont = const(spec.continuous_joints, device=dev)
        s_plan = cfg.t_plan / cfg.duration
        t_plan = self._const(cfg.t_plan)     # a device tensor: the solver's graph makes none
        # per-world data broadcast against K (..., B, S, n)
        q0b, qd0b = prob.q0[:, None], prob.qd0[:, None]
        Tqd0b, TTqdd0b = prob.Tqd0[:, None], prob.TTqdd0[:, None]
        k_rng = prob.k_range if prob.k_range.ndim == 1 else prob.k_range[:, None]
        q_desb = q_des[:, None]
        t_rad = prob.t_rad[:, None]                              # (B, 1, T, nf)

        def f_fn(K):
            if armtd:
                q_plan, _, _ = armtd_ref(q0b, qd0b, k_rng * K, t_plan, cfg.t_plan, cfg.duration)
            else:
                q_plan = q_des_fn(q0b, Tqd0b, TTqdd0b, k_rng * K, s_plan)
            d = q_plan - q_desb
            d = torch.where(cont, wrap_to_pi(d), d)
            return cfg.cost_scale * torch.sum(d * d, dim=-1)

        def pv_fn(K):
            """Position/velocity-limit block (tiny closed forms)."""
            if armtd:
                mn, mx = armtd_position_extrema(q0b, qd0b, k_rng, K, cfg.t_plan, cfg.duration)
                vn, vx = armtd_velocity_extrema(qd0b, k_rng, K, cfg.t_plan)
            else:
                mn, mx = joint_position_extrema(q0b, Tqd0b, TTqdd0b, k_rng, K)
                vn, vx = joint_velocity_extrema(q0b, Tqd0b, TTqdd0b, k_rng, K, cfg.duration)
            return torch.cat([pos_lb - mn, mn - pos_ub, pos_lb - mx, mx - pos_ub,
                              vel_lb - vn, vn - vel_ub, vel_lb - vx, vx - vel_ub], dim=-1)

        def cj_multi(K):
            """K (B, S, n) -> (c (B, S, m), Jt (B, S, n, m)) with ONE pass
            over the collision bank for all worlds and starts (smooth mode:
            the log-sum-exp bound in plain tensor code, no kernel)."""
            S = K.shape[1]
            vals, jacs = [], []
            if prob.u is not None:
                u_c, _, du = prob.u.slice_with_jac_multi(K)      # (B,S,T,nf), (B,S,n,T,nf)
                Ju = du.reshape(B, S, nf, -1)
                vals.append((u_c - (t_lim - t_rad)).reshape(B, S, -1))
                jacs.append(Ju)
                vals.append(((-t_lim + t_rad) - u_c).reshape(B, S, -1))
                jacs.append(-Ju)
            if prob.grasp is not None:
                gc, gr, dgc = prob.grasp.slice_with_jac_multi(K)
                vals.append((gc + gr[:, None]).reshape(B, S, -1))
                jacs.append(dgc.reshape(B, S, nf, -1))
            centers, _, dcenters = prob.links.slice_with_jac_multi(K)
            if cfg.smooth_collision_tau > 0.0:
                g, Jg = smooth_collision_constraints_with_jac(prob.hp, centers, dcenters,
                                                              cfg.smooth_collision_tau)
            else:
                g, Jg = collision_constraints_with_jac_multi(prob.hp, centers, dcenters)
            if collision_group is not None:
                g, Jg = gather_obstacles(g, collision_group), gather_obstacles(Jg, collision_group)
            vals.append(g.reshape(B, S, -1))
            jacs.append(Jg.reshape(B, S, nf, -1))
            if prob.si_diff is not None:
                cs, Js = self_intersection_with_jac_multi(prob.si_diff, prob.si_rad, K)
                vals.append(cs.reshape(B, S, -1))
                jacs.append(Js.reshape(B, S, nf, -1))
            vals.append(pv_fn(K))
            jacs.append(diagonal_jacobian_t(pv_fn, K))
            return torch.cat(vals, dim=-1), torch.cat(jacs, dim=-1)

        return NLPFunctions(f_fn, pv_fn, cj_multi)

    def solve(self, prob: ProblemData, q_des, k_rand=None, k_warm=None,
              generator: torch.Generator | None = None, collision_group=None,
              eager: bool = False, keep: dict | None = None) -> PlanResult:
        """NLP phase: constraint closures over a built problem -> multi-start
        ALM -> strict re-verification (`armour.py:347-607`): fused with the
        solver's carried values in hard-max mode, an explicit pass over the
        candidate pool in smooth mode.  On a card the solver's Gauss-Newton
        iteration runs as a CUDA graph; ``eager=True`` runs it op by op, to
        hold the two against each other.

        ``collision_group``: the process group of a constraint-parallel
        ("cp") shard of the obstacle axis (`parallel/mesh.py`).  Each rank's
        bank holds its slice of the obstacle slots; the collision block is
        all-gathered over the group along the obstacle axis, so every rank
        sees the unsharded constraint vector.  Every rank of the group must
        be given the same starts.  The gather is a collective that no graph
        here captures (a group of gloo ranks has none to capture, and one
        NCCL rank per card needs several cards to check a capture), so a
        sharded solve runs op by op, through ``keep``'s buffers where it is
        given.

        ``keep``: the solve's state and steps across calls of one shape
        (``solve_box_alm_multi``), and the verification as one more step
        whose result is kept in buffers (a later call overwrites them); on a
        card each step is a graph.  ``prob`` and ``q_des`` must then be the
        same tensors in every call (``PlanProgram``)."""
        spec, cfg, dtype, dev = self.spec, self._cfg, self.dtype, self.device
        nf = spec.n_factors
        B = prob.q0.shape[0]
        t_lim = self._const(spec.torque_limits)
        t_rad = prob.t_rad[:, None]                              # (B, 1, T, nf)
        f_fn, pv_fn, cj_multi = self.nlp_functions(prob, q_des, collision_group)

        # multi-start: k = 0 (reference init, NLPclass.cu:193-199) + warm
        # start + random interior points (uarmtd_planner.m:768)
        if k_rand is None:
            k_rand = self.random_starts(B, generator)
        k_warm = torch.zeros((B, nf), dtype=dtype, device=dev) if k_warm is None else self._t(k_warm)
        K0 = torch.cat([torch.zeros((B, 1, nf), dtype=dtype, device=dev), k_warm[:, None],
                        self._t(k_rand)], dim=1)
        if keep and "K0" in keep:
            keep["K0"].copy_(K0)         # a kept solve reads its starts at one address
            K0 = keep["K0"]

        eager = eager or collision_group is not None
        sol = solve_box_alm_multi(f_fn, cj_multi, K0, outer_iters=cfg.nlp_outer_iters,
                                  inner_iters=cfg.nlp_inner_iters, separable_cost=True,
                                  eager=eager, keep=keep)

        def verify() -> PlanResult:
            pool = torch.cat([sol.k, sol.k_feas, K0[:, :2]], dim=1)   # (B, 2S+2, n)
            if cfg.smooth_collision_tau == 0.0:
                # strict re-verification, FUSED (`armour.py:485-551`): the solver's
                # carried constraint values are exact at the final iterates (sol.c)
                # and at the starts (sol.c0), and the strictly-feasible incumbents
                # satisfy max c <= 0 < every threshold by construction, so the pool
                # (final iterates, incumbents, k = 0 and the warm start) is judged
                # with no extra pass over the bank
                m = sol.c0.shape[-1]
                parts = []
                if prob.u is not None:
                    m_t = int(np.prod(prob.u.c.shape[1:]))
                    parts += [(m_t, cfg.torque_violation_threshold)] * 2
                if prob.grasp is not None:
                    parts.append((int(np.prod(prob.grasp.c.shape[1:])), 1e-6))
                # the self-intersection rows sit between the collision block and
                # the state block, and take the collision threshold
                m_si = 0 if prob.si_diff is None else int(np.prod(prob.si_rad.shape[1:3]))
                m_tail = 8 * nf
                parts.append((m - sum(p[0] for p in parts) - m_si - m_tail,
                              cfg.collision_violation_threshold))
                parts.append((m_si, cfg.collision_violation_threshold))
                parts.append((m_tail, cfg.state_violation_threshold))
                thr = torch.cat([torch.full((sz,), t, dtype=dtype, device=dev) for sz, t in parts])

                feas0 = torch.all(sol.c0 <= thr, dim=-1)
                viol0 = torch.amax(sol.c0, dim=-1)
                feas = torch.cat([torch.all(sol.c <= thr, dim=-1), sol.found_feas | feas0,
                                  feas0[:, :2]], dim=1)
                viols = torch.cat([torch.amax(sol.c, dim=-1),
                                   torch.where(sol.found_feas, sol.v_feas, viol0), viol0[:, :2]], dim=1)
            else:
                # smooth mode keeps the explicit pass (`armour.py:553-607`): the
                # solver's values are the smooth conservative bound, while the
                # verification contract is against the hard max.  One launch of
                # the values-only kernel covers the whole pool.
                Np = pool.shape[1]
                blocks = []                                       # (values (B, Np, ...), threshold)
                if prob.u is not None:
                    u_c, _, _ = prob.u.slice_with_jac_multi(pool)          # (B, Np, T, nf)
                    blocks.append((torch.maximum(u_c - (t_lim - t_rad), (-t_lim + t_rad) - u_c),
                                   cfg.torque_violation_threshold))
                if prob.grasp is not None:
                    gc, gr, _ = prob.grasp.slice_with_jac_multi(pool)
                    blocks.append((gc + gr[:, None], 1e-6))
                centers, _, _ = prob.links.slice_with_jac_multi(pool)
                col = collision_values_multi(prob.hp, centers)
                if collision_group is not None:
                    col = gather_obstacles(col, collision_group)
                blocks.append((col, cfg.collision_violation_threshold))
                if prob.si_diff is not None:
                    blocks.append((self_intersection_values_multi(prob.si_diff, prob.si_rad, pool),
                                   cfg.collision_violation_threshold))
                blocks.append((pv_fn(pool), cfg.state_violation_threshold))
                worst = [(v.reshape(B, Np, -1).amax(dim=-1), thr) for v, thr in blocks]
                feas = torch.stack([v <= thr for v, thr in worst]).all(dim=0)
                viols = torch.stack([v for v, _ in worst]).amax(dim=0)
            costs = torch.where(feas, f_fn(pool), torch.inf)
            best = torch.argmin(costs, dim=1, keepdim=True)           # (B, 1)
            feasible = torch.gather(feas, 1, best)[:, 0]
            k_best = torch.gather(pool, 1, best[..., None].expand(-1, -1, nf))[:, 0]
            return PlanResult(
                k=torch.where(feasible[:, None], k_best, torch.nan),
                feasible=feasible,
                cost=torch.gather(costs, 1, best)[:, 0] / cfg.cost_scale,
                max_violation=torch.gather(viols, 1, best)[:, 0],
                torque_radius=prob.t_rad,
            )

        if keep is None:
            return verify()
        if "verify" not in keep:
            def step():
                keep["result"] = keep_into(keep.get("result"), verify())

            keep["verify"] = stepper(step, dev, eager)
        keep["verify"]()
        return keep["result"]

    # -- entry points -----------------------------------------------------
    def plan_batch(self, q0, qd0, qdd0, q_des, zonos, masks, k_rand=None, k_warm=None,
                   generator: torch.Generator | None = None, eager: bool = False) -> PlanResult:
        """Plan B worlds: q0/qd0/qdd0/q_des (B, nf), zonos (B, cap, 4, 3),
        masks (B, cap); ``k_rand`` (B, S-2, nf) overrides the random starts.

        The plan runs through the programs kept per (B, bucket)
        (``run_program``); ``eager=True`` builds (``build_probs``) and
        solves op by op with no program, to hold the two against each
        other."""
        if eager:
            probs = self.build_probs(q0, qd0, qdd0, zonos, masks)
            return self.solve(probs, q_des, k_rand=k_rand, k_warm=k_warm, generator=generator,
                              eager=True)
        return self.run_program(q0, qd0, qdd0, q_des, zonos, masks, k_rand, k_warm, generator)[0]

    def run_program(self, q0, qd0, qdd0, q_des, zonos, masks, k_rand=None, k_warm=None,
                    generator: torch.Generator | None = None, full_width: bool = False,
                    marks: dict | None = None, eager: bool = False, collision_group=None):
        """(plan, problem) of B worlds through the programs kept in
        ``batch_programs``, the counterpart of the JAX package's compiled
        batched build and solve (`armour.py:124-189`).  The random starts are
        drawn here, outside the programs, as ``solve`` draws them.  The plan
        is the caller's; the problem is the program's (its ``k_range`` and
        bank are read by the episode drivers), overwritten by the next call
        at its key.

        As ``build_probs`` decides: without culling, or at a bucket b0 of 8,
        one program of key (B, b0) builds the reachable sets and the bank of
        the first b0 slots and solves.  With culling, the ``ReachStage`` of
        key (B, cap, "reach") builds the reachable sets and the keep mask,
        the mask makes the one host trip (the stable compaction order and
        the bucket b are computed there), and the program of key
        (B, cap, b) compacts, builds the bank from the stage's outputs and
        solves.  ``full_width=True`` builds every slot as given, with no
        culling (key (B, cap): the episode program's plan).

        ``marks``: a dict that receives the host clock (``time.perf_counter``)
        after the build and after the solve, each taken after a device
        synchronise (the episode drivers' trace).

        ``eager=True`` builds (``build_fixed`` at full width, else
        ``build_probs``) and solves op by op with no program, to hold the
        two against each other; the problem is then the call's own.

        ``collision_group``: a cp shard's plan (``solve``; full width only,
        so that every rank's bank has one shape), kept at key
        (B, cap, group).  The starts of the group's first rank replace this
        rank's (``broadcast_starts``): in the program's starts buffer, or in
        a copy with ``eager``."""
        q0, qd0, qdd0, q_des, zonos = (self._t(x) for x in (q0, qd0, qdd0, q_des, zonos))
        masks = self._t(masks, torch.bool)
        B, cap = masks.shape
        if collision_group is not None and not full_width:
            raise ValueError("a cp shard's plan builds every slot: full_width=True")
        k_rand = self.random_starts(B, generator) if k_rand is None else self._t(k_rand)
        k_warm = torch.zeros_like(k_rand[:, 0]) if k_warm is None else self._t(k_warm)
        if eager:
            prob = (self.build_fixed if full_width else self.build_probs)(q0, qd0, qdd0, zonos, masks)
            _mark(marks, "built", self.device)
            if collision_group is not None:
                k_rand = broadcast_starts(k_rand.clone(), collision_group)
            res = self.solve(prob, q_des, k_rand=k_rand, k_warm=k_warm, eager=True,
                             collision_group=collision_group)
            _mark(marks, "solved", self.device)
            return res, prob
        progs = self.batch_programs
        b = cap if full_width else obstacle_bucket(masks)
        if full_width or not self.cfg.obstacle_culling or b <= 8:
            # a program gathers over the group it was made with
            key = (B, b) if collision_group is None else (B, b, collision_group)
            make = lambda: PlanProgram(self, b, B, collision_group=collision_group)  # noqa: E731
            zonos, masks = zonos[:, :b], masks[:, :b]
        else:
            reach = progs.run((B, cap, "reach"), lambda: ReachStage(self, B, cap),
                              q0, qd0, qdd0, zonos, masks)
            key, make = (B, cap, reach.bucket), lambda: PlanProgram(self, reach.bucket, B, reach)
        res = progs.run(key, make, q0, qd0, qdd0, q_des, zonos, masks, k_rand, k_warm, marks=marks)
        return res, progs.entries[key].prob

    def plan(self, q0, qd0, qdd0, q_des, obstacles: ObstacleSet, k_rand=None, k_warm=None,
             generator: torch.Generator | None = None, eager: bool = False) -> PlanResult:
        """Plan one world (no culling, as the reference's single-plan
        program): obstacles.zonos (cap, 4, 3), obstacles.mask (cap,).

        The plan runs through a ``PlanProgram`` of key (1, bucket), kept in
        ``programs`` (the bucket computed here on the host; the planner's
        dtype, trajectory type, starts, T and mode switches are fixed when
        it is made), the counterpart of the JAX package's ``jax.jit`` of its
        plan function (`armour.py:108`): on a card its first call captures,
        every later call replays.  The random starts are drawn here, outside
        the program, as ``solve`` draws them.  ``eager=True`` builds and
        solves op by op with no program, to hold the two against each
        other."""
        b, args = self.plan_args(q0, qd0, qdd0, q_des, obstacles, k_rand, k_warm, generator)
        if eager:
            res = self.plan_fixed(*args, eager=True)
        else:
            res = self.programs.run((1, b), lambda: PlanProgram(self, b), *args)
        return PlanResult(*(x[0] for x in res))

    def plan_args(self, q0, qd0, qdd0, q_des, obstacles: ObstacleSet, k_rand=None, k_warm=None,
                  generator: torch.Generator | None = None):
        """(bucket, the arguments of ``plan_fixed`` and of a ``PlanProgram``)
        of one world: a batch of 1 at its obstacle bucket, the starts drawn."""
        b = obstacle_bucket(obstacles.mask)
        q0, qd0, qdd0, q_des = (self._t(x)[None] for x in (q0, qd0, qdd0, q_des))
        return b, (q0, qd0, qdd0, q_des,
                   self._t(obstacles.zonos)[None, :b], self._t(obstacles.mask, torch.bool)[None, :b],
                   self.random_starts(1, generator) if k_rand is None else self._t(k_rand)[None],
                   torch.zeros_like(q0) if k_warm is None else self._t(k_warm)[None])

    @property
    def programs(self) -> ProgramCache:
        """The planner's ``plan`` programs, at most 4 obstacle buckets."""
        if "_programs" not in self.__dict__:
            self._programs = ProgramCache(4)
        return self._programs

    @property
    def batch_programs(self) -> ProgramCache:
        """The planner's batched programs (``run_program``): every bucket of
        one B and its ``ReachStage`` (``max_obstacles / 8 + 1`` entries), so
        that a battery moving between buckets never evicts."""
        if "_batch_programs" not in self.__dict__:
            self._batch_programs = ProgramCache(-(-self.cfg.max_obstacles // 8) + 1)
        return self._batch_programs

    def build_fixed(self, q0, qd0, qdd0, zonos, masks) -> ProblemData:
        """``build_probs`` without culling at the bucket the caller chose
        (the obstacle axis of ``zonos`` and ``masks``): no host round trip."""
        prob, link_gens, _, _ = self.reachable_sets(q0, qd0, qdd0)
        return prob._replace(hp=self.buffer(link_gens, zonos, masks))

    def plan_fixed(self, q0, qd0, qdd0, q_des, zonos, masks, k_rand, k_warm,
                   eager: bool = False) -> PlanResult:
        """Build and solve composed with no host round trip (the JAX
        ``_make_plan_fn``): a batch at the given bucket, no culling, the
        starts given."""
        prob = self.build_fixed(q0, qd0, qdd0, zonos, masks)
        return self.solve(prob, q_des, k_rand=k_rand, k_warm=k_warm, eager=eager)


def _mark(marks: dict | None, name: str, device):
    """``marks[name]``: the host clock after a device synchronise."""
    if marks is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks[name] = time.perf_counter()


class ReachStage:
    """The first stage of a culled batched plan, kept per (B, cap) in the
    planner's ``batch_programs`` (the counterpart of the JAX package's
    ``_rs_map`` and ``_cull_jit``, `armour.py:124-131`): the reachable sets
    and the whole-FRS keep mask of B worlds at every slot, built from input
    tensors at fixed addresses into output buffers (``out``: the problem
    without its bank, the links' independent generators and the keep mask)
    as one step, a CUDA graph on a card.  A call then copies the keep mask
    to the host, computes the stable compaction order and the bucket there
    (``bucket``; the order goes to ``order``, a buffer on the device) and
    returns the stage.  The ``PlanProgram`` of each bucket reads these
    buffers (its ``parent``)."""

    parent = None

    def __init__(self, planner: ArmourPlanner, batch: int, cap: int):
        planner = weakref.proxy(planner)     # the planner's cache holds the stage
        nf, dt, dev = planner.spec.n_factors, planner.dtype, planner.device
        vec = lambda *shape: torch.zeros((batch, *shape), dtype=dt, device=dev)  # noqa: E731
        self.inputs = (vec(nf), vec(nf), vec(nf), vec(cap, 4, 3),
                       torch.zeros((batch, cap), dtype=torch.bool, device=dev))
        self.order = torch.zeros((batch, cap), dtype=torch.long, device=dev)
        self.out = None
        self.bucket = None

        def reach():
            prob, link_gens, aabb_c, aabb_r = planner.reachable_sets(*self.inputs[:3])
            keep = planner.cull_keep(aabb_c, aabb_r, *self.inputs[3:])
            self.out = keep_into(self.out, (prob, link_gens, keep))

        self.step = stepper(reach, dev, eager=False)

    @property
    def steps(self) -> list:
        return [] if self.step is None else [self.step]

    def __call__(self, q0, qd0, qdd0, zonos, masks) -> "ReachStage":
        for buf, x in zip(self.inputs, (q0, qd0, qdd0, zonos, masks)):
            buf.copy_(x)
        self.step()
        order, self.bucket = cull_order(self.out[2].cpu().numpy())   # the one host trip
        self.order.copy_(torch.as_tensor(order))
        return self

    def release(self):
        release(self.step)
        self.step, self.out, self.inputs, self.order = None, None, (), None


class PlanProgram:
    """A plan of ``batch`` worlds at one obstacle bucket, kept: input
    tensors at fixed addresses into which each call copies its arguments,
    the build and the solve composed with no host round trip, and the
    result copied out (the program's problem, ``prob``, is overwritten by
    the next call).  One class serves ``plan`` (B = 1, key (1, bucket)),
    the episode program's plan (B worlds at every slot) and the culled
    batched plan of ``plan_batch`` and the battery driver, whose build
    reads the outputs of its ``parent``, a ``ReachStage``
    (``ArmourPlanner.run_program``).

    The steps, each a CUDA graph on a card (`utils/graphs.py`; the first
    call runs each op by op and captures it, every later call replays): the
    build (the reachable sets and the bank of the first ``bucket`` slots;
    with a parent, the compaction and the bank only), the solver's first
    bank pass, its Gauss-Newton iteration (64 replays per plan), its outer
    update (8) and the verification with the choice of the best plan
    (``ArmourPlanner.solve(keep=...)``).  No graph is launched inside
    another capture.  On the CPU all of it runs op by op through the same
    buffers.  With a ``collision_group`` (a cp shard of the sharded step,
    `parallel/mesh.py`) a call first overwrites the starts buffer with the
    group's first rank's (``broadcast_starts``); the build stays a graph
    and the solve, which gathers, runs op by op (``solve``).  A call returns the plan; ``prob``
    holds the problem.  The program holds its planner weakly (the
    planner's caches hold programs), so the planner must outlive it."""

    STEPS = ("build", "first_pass", "iteration", "outer_update", "verification")

    def __init__(self, planner: ArmourPlanner, bucket: int, batch: int = 1,
                 reach: ReachStage | None = None, collision_group=None):
        planner = weakref.proxy(planner)     # the planner's cache holds the program
        spec, cfg, dt, dev = planner.spec, planner._cfg, planner.dtype, planner.device
        nf = spec.n_factors
        vec = lambda *shape: torch.zeros((batch, *shape), dtype=dt, device=dev)  # noqa: E731
        self.planner, self.parent, self.device = planner, reach, dev
        self.collision_group = collision_group
        # the buffers of the plan's arguments that this program reads itself
        # (q0, qd0, qdd0, q_des, zonos, masks, k_rand, k_warm; with a parent
        # the stage holds the first three and the obstacles)
        starts = (vec(max(cfg.nlp_num_starts - 2, 1), nf), vec(nf))
        q_des = vec(nf)
        if reach is None:
            self.take = range(8)
            self.inputs = (vec(nf), vec(nf), vec(nf), q_des, vec(bucket, 4, 3),
                           torch.zeros((batch, bucket), dtype=torch.bool, device=dev), *starts)
        else:
            self.take = (3, 6, 7)
            self.inputs = (q_des, *starts)
        self.solve_inputs = (q_des, *starts)
        self.prob = None                 # the built problem
        self.keep = {}                   # the solve's kept state and steps

        def build():
            if reach is None:
                prob = planner.build_fixed(*self.inputs[:3], *self.inputs[4:6])
                self.prob = keep_into(self.prob, prob)
                return
            prob, link_gens, keep = reach.out
            hp = planner.buffer(link_gens, *compact(reach.inputs[3], keep, reach.order, bucket))
            self.prob = prob._replace(hp=keep_into(None if self.prob is None else self.prob.hp, hp))

        self.build = stepper(build, dev, eager=False)

    @property
    def steps(self) -> list:
        """The build's step, the solve's three and the verification's
        (``STEPS`` names them)."""
        if self.build is None:
            return []
        verify = [self.keep["verify"]] if "verify" in self.keep else []
        return [self.build, *self.keep.get("steps", ()), *verify]

    def __call__(self, *args, marks: dict | None = None):
        for buf, i in zip(self.inputs, self.take):
            buf.copy_(args[i])
        q_des, k_rand, k_warm = self.solve_inputs
        if self.collision_group is not None:
            broadcast_starts(k_rand, self.collision_group)    # the address the kept steps read
        self.build()
        _mark(marks, "built", self.device)
        res = self.planner.solve(self.prob, q_des, k_rand=k_rand, k_warm=k_warm, keep=self.keep,
                                 collision_group=self.collision_group)
        res = tree_map(torch.clone, res)
        _mark(marks, "solved", self.device)
        return res

    def release(self):
        for step in self.steps:
            release(step)
        self.build, self.prob, self.keep, self.inputs, self.solve_inputs = None, None, {}, (), ()
