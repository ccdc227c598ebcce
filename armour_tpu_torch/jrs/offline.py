"""Loader for the reference's offline ARMTD joint reachable sets.

Port of `armour_tpu/jrs/offline.py`.  The ARMTD comparison planner consumes
precomputed CORA zonotopes over [cos q, sin q, q, qd, k_a, k_v]: one .mat
per initial-velocity key c_kvi, 100 time steps each
(`offline_jrs/create_orig_offline_jrs.m`, `load_offline_jrs.m:82-100`).
scipy cannot read CORA's MCOS class objects directly, but the numeric
payload (each zonotope's 6xN Z = [center, generators] matrix) lives in the
file's MCOS subsystem stream, which this module parses.  The sets serve to
cross-validate the online 'orig' JRS (`jrs/armtd.py`) against the
reference's offline sets.

Reference slicing semantics reproduced here (`load_offline_jrs.m:82-100`):
pick the file with the key nearest the actual qd0, `zonotope_slice` the
k_v dimension (6) at qd0, rotate the (cos, sin) block by the initial angle
q0 and shift the q dimension by q0.  The loader reads files on the host;
the slicing runs on the device it is given (the card unless
``device="cpu"``).
"""

from __future__ import annotations

import glob
import io
import os
from typing import NamedTuple

import numpy as np
import torch

from armour_tpu_torch.device import resolve_device

OFFLINE_JRS_DIR = (
    "/root/reference/kinova_src/kinova_simulator_interfaces/"
    "kinova_planner_realtime_armtd_comparison/offline_jrs/"
    "orig_parameterization"
)

# zonotope state dims (create_orig_offline_jrs.m)
DIM_COS, DIM_SIN, DIM_Q, DIM_QD, DIM_KA, DIM_KV = range(6)


class OfflineJRS(NamedTuple):
    """One velocity-key file: Z[t] is the 6 x (1 + n_gen) zonotope matrix
    of time step t (column 0 = center)."""

    c_kvi: float
    t_plan: float
    t_total: float
    Z: list  # length 100


def _extract_mcos_f64(path: str) -> list:
    """All 6-row float64 matrices from the .mat's MCOS subsystem, in file
    order: exactly the 100 per-time-step zonotope Z matrices."""
    import scipy.io as sio

    # MCOS class payloads are not part of scipy's public API; this reader
    # walks the __function_workspace__ stream through a private scipy
    # module that may move between releases.  Fail loudly rather than
    # silently breaking the offline-parity path.
    try:
        from scipy.io.matlab._mio5 import MatFile5Reader
    except ImportError as e:  # pragma: no cover
        import scipy

        raise ImportError(
            "scipy.io.matlab._mio5.MatFile5Reader is unavailable in scipy "
            f"{scipy.__version__}; the CORA-MCOS offline-JRS reader was "
            "written against scipy 1.16-1.17.  Update _extract_mcos_f64 for "
            "the new private-module layout."
        ) from e

    m = sio.loadmat(path)
    fw = m["__function_workspace__"]
    stream = io.BytesIO(fw.tobytes())
    rdr = MatFile5Reader(stream)
    rdr.byte_order = "<"
    rdr.mat_stream.seek(8)
    rdr.initialize_read()
    hdr, _ = rdr.read_var_header()
    tree = rdr.read_var_array(hdr)

    found: list = []

    def walk(x, depth=0):
        if depth > 8:
            return
        if isinstance(x, np.ndarray):
            if x.dtype == np.float64 and x.ndim == 2 and x.shape[0] == 6:
                found.append(np.array(x))
            elif x.dtype == object:
                for y in x.flat:
                    walk(y, depth + 1)
            elif x.dtype.names:
                for n in x.dtype.names:
                    for y in np.atleast_1d(x[n]).flat:
                        walk(y, depth + 1)

    walk(tree)
    return found


def available(dirpath: str = OFFLINE_JRS_DIR) -> bool:
    return os.path.isdir(dirpath) and bool(glob.glob(os.path.join(dirpath, "JRS_*.mat")))


def load_offline_jrs(qd0_j: float, dirpath: str = OFFLINE_JRS_DIR) -> OfflineJRS:
    """Nearest-velocity-key file for one joint (`load_offline_jrs.m:84-86`),
    as host arrays."""
    import scipy.io as sio

    files = glob.glob(os.path.join(dirpath, "JRS_*.mat"))
    keys = np.array([float(os.path.basename(f)[4:-4]) for f in files])
    f = files[int(np.argmin(np.abs(keys - qd0_j)))]
    m = sio.loadmat(f)
    Z = _extract_mcos_f64(f)
    assert len(Z) == 100, f"{f}: expected 100 zonotopes, got {len(Z)}"
    return OfflineJRS(
        c_kvi=float(m["current_c_kvi"].squeeze()),
        t_plan=float(m["t_plan"].squeeze()),
        t_total=float(m["t_total"].squeeze()),
        Z=Z,
    )


def zonotope_slice(Z, dim: int, value: float, device=None) -> torch.Tensor:
    """CORA zonotope_slice: substitute the slice generator of ``dim`` at
    ``value`` (the center shifts by lambda * g, the generator is removed).
    ``Z`` (6, 1 + n_gen) goes to ``device`` in float64; the result stays
    there."""
    Z = torch.as_tensor(Z, dtype=torch.float64, device=resolve_device(device))
    c, G = Z[:, 0], Z[:, 1:]
    idx = torch.nonzero(G[dim] != 0)[:, 0].tolist()
    assert len(idx) == 1, f"dim {dim}: expected one slice generator, got {len(idx)}"
    g = G[:, idx[0]]
    lam = (value - c[dim]) / g[dim]
    lam_h = float(lam)
    assert -1.0 - 1e-9 <= lam_h <= 1.0 + 1e-9, (
        f"slice value {value} outside the set (lambda={lam_h})")
    return torch.cat([(c + lam * g)[:, None], G[:, :idx[0]], G[:, idx[0] + 1:]], dim=1)


def sliced_cos_sin_intervals(jrs: OfflineJRS, q0_j: float, qd0_j: float, k_actual: float,
                             device=None):
    """Per-time-step [lo, hi] of cos q and sin q after slicing k_v at qd0,
    slicing k_a at k_actual, and rotating by the initial angle q0
    (`load_offline_jrs.m:88-100` + the NLP's k slice).

    Returns (cos_lo, cos_hi, sin_lo, sin_hi, g_ka): four (100,) float64
    tensors on ``device`` and the set's k_a generator magnitude (the offline
    mode's g_k) as a float."""
    device = resolve_device(device)
    cq, sq = float(np.cos(q0_j)), float(np.sin(q0_j))
    g_ka = None
    rows = []
    for Zt in jrs.Z:
        Z = zonotope_slice(Zt, DIM_KV, qd0_j, device)
        if g_ka is None:
            ka_col = torch.nonzero(Z[DIM_KA, 1:] != 0)[0, 0]
            g_ka = float(Z[DIM_KA, 1 + ka_col].abs())
        Z = zonotope_slice(Z, DIM_KA, k_actual, device)
        # rotate the (cos, sin) block by q0 (A matrix, load_offline_jrs.m:92)
        cos_row = cq * Z[DIM_COS] - sq * Z[DIM_SIN]
        sin_row = sq * Z[DIM_COS] + cq * Z[DIM_SIN]
        rows.append(torch.stack([cos_row[0], cos_row[1:].abs().sum(),
                                 sin_row[0], sin_row[1:].abs().sum()]))
    c_cos, r_cos, c_sin, r_sin = torch.stack(rows, dim=1)
    return c_cos - r_cos, c_cos + r_cos, c_sin - r_sin, c_sin + r_sin, g_ka
