"""State carried across from the JAX package.

This system has no weights: what crosses is the robot and the built
problem.  These functions turn the JAX package's data, handed over by the
caller as numpy arrays, into the port's tensors on a given device and
dtype, so a test can feed the exact JAX bank and reachable sets into the
port's kernels and solver and locate a difference in one module.

Arrays of ONE world gain the port's leading world axis (B = 1).  As every
entry point of the port, these put their tensors on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from armour_tpu_torch.collision.zonotope import BufferedHyperplanes
from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.ops.pz import PackedPZ
from armour_tpu_torch.planner.armour import ProblemData
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.sim.agent import TrajParams, TrueParams


def spec_from_arrays(**fields) -> RobotSpec:
    """RobotSpec from the JAX spec's fields (numpy arrays and scalars)."""
    names = {f.name for f in dataclasses.fields(RobotSpec)}
    kw = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
          for k, v in fields.items() if k in names}
    return RobotSpec(**kw)


def _t(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)


def bank_from_numpy(A, dpos, dneg, obs_mask, device=None, dtype=torch.float64) -> BufferedHyperplanes:
    """One world's bank: A (P,3,L,O,T), dpos/dneg (P,L,O,T), obs_mask (O,).
    A keeps bfloat16 when it was stored so (bf16 -> f64 -> bf16 is exact);
    the offsets take ``dtype``."""
    device = resolve_device(device)
    a_dtype = torch.bfloat16 if str(np.asarray(A).dtype) == "bfloat16" else dtype
    A_t = torch.as_tensor(np.asarray(A).astype(np.float64), device=device).to(a_dtype)
    return BufferedHyperplanes(
        A_t[None].contiguous(),
        _t(dpos, device, dtype)[None].contiguous(),
        _t(dneg, device, dtype)[None].contiguous(),
        torch.as_tensor(np.array(obs_mask, dtype=bool), device=device)[None],
    )


def packed_pz_from_numpy(c, G, r, basis, device=None, dtype=torch.float64) -> PackedPZ:
    """One world's packed PZ: c/r (*shape), G (NG, *shape); the static
    basis tuple is carried as is."""
    device = resolve_device(device)
    return PackedPZ(_t(c, device, dtype)[None], _t(G, device, dtype)[:, None],
                    _t(r, device, dtype)[None], tuple(basis))


def problem_from_numpy(links, u, hp, t_rad, q0, qd0, Tqd0, TTqdd0, k_range, grasp=None,
                       device=None, dtype=torch.float64) -> ProblemData:
    """One world's built problem.  ``links``/``u``/``grasp``: (c, G, r, basis),
    or None for ``u`` and ``grasp``; ``hp``: (A, dpos, dneg, obs_mask);
    ``k_range`` (nf,) is this world's and is stored per world, (1, nf)."""
    device = resolve_device(device)

    def pz(p):
        return None if p is None else packed_pz_from_numpy(*p, device=device, dtype=dtype)

    return ProblemData(
        links=pz(links),
        u=pz(u),
        grasp=pz(grasp),
        hp=bank_from_numpy(*hp, device=device, dtype=dtype),
        t_rad=_t(t_rad, device, dtype)[None],
        q0=_t(q0, device, dtype)[None],
        qd0=_t(qd0, device, dtype)[None],
        Tqd0=_t(Tqd0, device, dtype)[None],
        TTqdd0=_t(TTqdd0, device, dtype)[None],
        k_range=_t(k_range, device, dtype)[None],
    )


def traj_params_from_numpy(q0, qd0, qdd0, k_actual, t_offset, device=None,
                           dtype=torch.float64) -> TrajParams:
    """The JAX package's ``TrajParams`` fields, of one world (nf,) or of
    several (B, nf), as the port's."""
    device = resolve_device(device)
    return TrajParams(*(_t(x, device, dtype) for x in (q0, qd0, qdd0, k_actual, t_offset)))


def true_params_from_numpy(mass_scale, inertia_scale, device=None, dtype=torch.float64) -> TrueParams:
    """The JAX package's ``TrueParams`` fields as the port's."""
    device = resolve_device(device)
    return TrueParams(_t(mass_scale, device, dtype), _t(inertia_scale, device, dtype))
