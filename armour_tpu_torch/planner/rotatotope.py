"""Legacy rotatotope RTD planners: the self-intersection constraint block.

Port of `armour_tpu/planner/rotatotope.py` (see its module docstring for
the design).  A rotatotope (a rotation-matrix set over the trajectory
parameter k times a link-volume zonotope, composed down the chain) is what
the polynomial-zonotope forward kinematics with the ARMTD 'orig' JRS
computes, so the legacy planner is ``ArmourPlanner(traj_type="orig")``
plus what this module adds: non-adjacent link reachable volumes must stay
separated over the whole horizon
(`robot_arm_rotatotope_RTD_planner_3D_fetch.m:107-109`).

Per (time, pair) the difference set D_ij(k) = FRS_i - FRS_j is a
k-sliceable PZ plus both links' independent generators, bounded by their
axis-aligned radius R:

    feasible(t, ij)  iff  min over the 6 faces of (R_a + r_a) -/+ d_a(k) <= 0,

with the exact Jacobian of the argmin face.  The JAX package computes this
in plain array code outside any Pallas kernel, and so does the port.

Shapes carry the world axis B in front: the bank is (B, T, P, 3) for P
pairs, K is (B, S, n).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from armour_tpu_torch.dynamics.rnea import forward_kinematics
from armour_tpu_torch.ops.pz import PackedPZ, pack_pzs
from armour_tpu_torch.robots.spec import RobotSpec


def self_intersection_pairs(spec: RobotSpec, margin: float = 0.1) -> list:
    """Link pairs (i, j), j >= i + 2, whose bounding boxes are separated by
    more than ``margin`` at the home configuration (q = 0).

    Adjacent links share a joint and always touch; pairs whose home-pose
    clearance is below the FRS fattening scale (about 0.1 m at the
    reference trajectory parameters) are too coarse for the box-level test
    and would reject valid postures (on the Kinova: the wrist cluster
    (3,5)/(4,6)).  Host-side and static.

    A PRUNED pair receives NO self-collision protection from this block, and
    the pruned pairs are the ones closest together: a warning names them.
    Callers who need a close pair covered pass an explicit pair list to
    ``ArmourPlanner(self_intersection=[...])``.
    """
    q0 = torch.zeros(spec.n_factors, dtype=torch.float64)
    Rw, pw = forward_kinematics(spec, q0)
    Rw = Rw.numpy()                          # (L, 3, 3)
    pw = pw.numpy()                          # (L, 3)
    c_l = np.asarray(spec.link_zono_center, float)
    g_l = np.asarray(spec.link_zono_gen, float)
    centers = pw + np.einsum("lij,lj->li", Rw, c_l)
    # world-frame AABB radius of the rotated box
    rad = np.einsum("lij,lj->li", np.abs(Rw), g_l)
    pairs, pruned = [], []
    for i in range(spec.n_joints):
        for j in range(i + 2, spec.n_joints):
            sep = np.abs(centers[i] - centers[j]) - (rad[i] + rad[j])
            if sep.max() > margin:
                pairs.append((i, j))
            else:
                pruned.append((i, j))
    if pruned:
        warnings.warn(
            "self_intersection_pairs: non-adjacent pairs "
            f"{pruned} are within {margin} m home-pose clearance and were "
            "PRUNED — they get no self-collision protection from this "
            "constraint block; pass an explicit pair list to cover them",
            stacklevel=2,
        )
    return pairs


def build_self_intersection(link_pz, link_indep_gens: torch.Tensor, pairs):
    """Difference bank for the NLP: (PackedPZ diff, centers (B, T, P, 3);
    R (B, T, P, 3)).

    ``link_pz``: per-link k-only 3-vector PZs, batch (B, T) (the output of
    `pz_forward_kinematics`); ``link_indep_gens``: (B, T, L, 3, 6)
    independent generators and radius columns.  R folds the axis-aligned
    radius of BOTH links' independent parts; the difference PZ's own error
    radius is added at slice time (PackedPZ.r).
    """
    diffs = [link_pz[i] - link_pz[j] for (i, j) in pairs]
    packed = pack_pzs([d.reduce() for d in diffs], axis=2)       # (B, T, P, 3)
    r_link = link_indep_gens.abs().sum(-1)                       # (B, T, L, 3)
    R = torch.stack([r_link[:, :, i] + r_link[:, :, j] for (i, j) in pairs], dim=2)
    return packed, R


def _faces(diff: PackedPZ, R: torch.Tensor, K: torch.Tensor):
    """The 6 faces (R + r) -/+ d: (B, S, T, P, 6), and dd/dk (B, S, n, T, P, 3)."""
    d, r, dd = diff.slice_with_jac_multi(K)        # (B,S,T,P,3), (B,T,P,3), (B,S,n,T,P,3)
    Rr = (R + r)[:, None]                          # (B, 1, T, P, 3)
    return torch.cat([Rr - d, Rr + d], dim=-1), dd


def self_intersection_with_jac_multi(diff: PackedPZ, R: torch.Tensor, K: torch.Tensor):
    """Start-batched constraint values and their exact Jacobian.

    K (B, S, n) -> (c (B, S, T, P), J (B, S, n, T, P)); feasible iff
    c <= 0.  c is the minimum over the 6 faces; J is the argmin face's
    -/+ dd_a/dk, where the FIRST minimum wins a tie (as ``jnp.argmin``).
    J is laid out with n before (T, P), as the NLP keeps its Jacobian.
    """
    faces, dd = _faces(diff, R, K)
    best = torch.argmin(faces, dim=-1, keepdim=True)              # (B, S, T, P, 1)
    c = torch.gather(faces, -1, best)[..., 0]
    # faces[..., :3] carry -dd, faces[..., 3:] carry +dd
    sign = torch.where(best >= 3, 1.0, -1.0).to(dd.dtype)[:, :, None, ..., 0]
    axis = (best % 3)[:, :, None].expand(dd.shape[:-1] + (1,))
    J = sign * torch.gather(dd, -1, axis)[..., 0]
    return c, J


def self_intersection_values_multi(diff: PackedPZ, R: torch.Tensor, K: torch.Tensor):
    """Value-only pass for the verification pool: (B, S, T, P)."""
    return torch.amin(_faces(diff, R, K)[0], dim=-1)


def rotatotope_planner(spec: RobotSpec, cfg, dtype=torch.float64, pairs=None, device=None):
    """The legacy planner, assembled: ARMTD 'orig' trajectories + obstacle
    constraints + self-intersection constraints
    (`robot_arm_rotatotope_RTD_planner_3D_fetch.m` replan()).  ``pairs``
    overrides the automatic home-separated pair selection; ``device``
    defaults to the card, as every entry point."""
    from armour_tpu_torch.planner.armour import ArmourPlanner

    return ArmourPlanner(
        spec, cfg, dtype, device=device, traj_type="orig",
        self_intersection=pairs if pairs is not None else True,
    )
