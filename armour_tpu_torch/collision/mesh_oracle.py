"""The exact mesh-level collision oracle: ctypes bindings for the port's
copy of the native checker (`armour_tpu_torch/csrc/mesh_oracle.cpp`), the
exact-geometry replacement of the reference's SurfaceIntersection post-hoc
collision check.

Port of `armour_tpu/collision/mesh_oracle.py`.  The library is built at
first use with ``g++ -O3 -shared -fPIC`` and ``-fopenmp`` into the
git-ignored ``armour_tpu_torch/build/`` and loaded with ctypes; where the
compiler has no OpenMP runtime it is built without ``-fopenmp`` (the
checks then run on one core, with the same results).  Unlike the JAX
package, which reports ``available() == False`` and lets its caller fall
back to the box screen, a failed build raises here: the box screen runs
only where the caller asks for it.  This is host code over numpy arrays,
as in the JAX package; there is no device path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "mesh_oracle.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# tried in order: the OpenMP build, then a serial one for a compiler
# without the OpenMP runtime
VARIANTS = (("-fopenmp",), ())


def library_path(extra_flags: tuple = VARIANTS[0]) -> Path:
    """The built library; its name carries a hash of the source and flags."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *extra_flags)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"{SOURCE.stem}-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the oracle unless a library for this source exists: with
    OpenMP where the compiler can, else without.  Raises if neither
    builds."""
    for extra in VARIANTS:
        if library_path(extra).exists():
            return library_path(extra)
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler found: the mesh oracle is built from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for extra in VARIANTS:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, *CXX_FLAGS, *extra, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, library_path(extra))
            return library_path(extra)
        os.unlink(tmp)
        errors.append(f"{' '.join(extra) or 'serial'} ({proc.returncode}): {proc.stderr}")
    raise RuntimeError("building the mesh oracle failed:\n" + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.mesh_oracle_set_meshes.argtypes = [
        ctypes.c_int, np.ctypeslib.ndpointer(np.int64, flags="C"), f64]
    lib.mesh_oracle_set_meshes.restype = None
    lib.mesh_oracle_check.argtypes = [
        ctypes.c_int64, ctypes.c_int, f64, f64, ctypes.c_int, f64,
        np.ctypeslib.ndpointer(np.uint8, flags="C")]
    lib.mesh_oracle_check.restype = None
    return lib


class MeshOracle:
    """Holds per-link triangle meshes and checks posed configurations.

    ``meshes``: list of (n_tri, 3, 3) float64 arrays in link frames.  Links
    without a mesh can pass their bounding box via ``box_mesh``.  The
    native library keeps one mesh set per process, so ``check`` registers
    this oracle's meshes before every query (7 links of a few triangles
    each: microseconds).
    """

    def __init__(self, meshes):
        self._lib = _lib()
        self.n_links = len(meshes)
        self._counts = np.array([m.shape[0] for m in meshes], np.int64)
        self._tris = np.ascontiguousarray(np.concatenate([m.reshape(-1, 3) for m in meshes]),
                                          np.float64)

    def check(self, R, pos, obstacles_aabb) -> np.ndarray:
        """R: (n_cfg, L, 3, 3), pos: (n_cfg, L, 3),
        obstacles_aabb: (n_obs, 6) = center + half extents.
        Returns (n_cfg,) bool."""
        R = np.ascontiguousarray(R, np.float64)
        pos = np.ascontiguousarray(pos, np.float64)
        obs = np.ascontiguousarray(obstacles_aabb, np.float64).reshape(-1, 6)
        n_cfg = R.shape[0]
        if R.shape != (n_cfg, self.n_links, 3, 3) or pos.shape != (n_cfg, self.n_links, 3):
            raise ValueError(f"poses must be ({n_cfg}, {self.n_links}, 3, 3) and "
                             f"({n_cfg}, {self.n_links}, 3), got {R.shape}, {pos.shape}")
        out = np.zeros(n_cfg, np.uint8)
        self._lib.mesh_oracle_set_meshes(self.n_links, self._counts, self._tris)
        self._lib.mesh_oracle_check(n_cfg, self.n_links, R, pos, obs.shape[0], obs, out)
        return out.astype(bool)


def box_mesh(center, half) -> np.ndarray:
    """12-triangle mesh of a box (for links without STL meshes)."""
    c = np.asarray(center, float)
    h = np.asarray(half, float)
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], float
    ) * h + c
    faces = [
        (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
        (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
        (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),
    ]
    return np.stack([corners[list(f)] for f in faces])


def load_stl_triangles(path) -> np.ndarray | None:
    """(n_tri, 3, 3) triangles from a binary/ASCII STL."""
    raw = Path(path).read_bytes()
    if len(raw) < 84:
        return None
    (n_tri,) = struct.unpack_from("<I", raw, 80)
    if 84 + n_tri * 50 == len(raw):
        tris = np.ndarray(
            (n_tri, 9), dtype="<f4", buffer=raw, offset=84 + 12, strides=(50, 4)
        ).reshape(n_tri, 3, 3)
        return np.asarray(tris, np.float64)
    verts = []
    for line in raw.decode(errors="ignore").splitlines():
        t = line.split()
        if len(t) == 4 and t[0] == "vertex":
            verts.append([float(t[1]), float(t[2]), float(t[3])])
    if not verts or len(verts) % 3:
        return None
    return np.asarray(verts, np.float64).reshape(-1, 3, 3)


def oracle_for_spec(spec, mesh_paths=None) -> MeshOracle:
    """Build an oracle for a RobotSpec: STL meshes when provided (default:
    ``spec.mesh_paths``), else the link bounding boxes (then it is the
    exact-SAT version of the box screen)."""
    if mesh_paths is None:
        mesh_paths = spec.mesh_paths
    meshes = []
    for i in range(spec.n_joints):
        tri = None
        if mesh_paths is not None and mesh_paths[i]:
            tri = load_stl_triangles(mesh_paths[i])
        if tri is None:
            tri = box_mesh(spec.link_zono_center[i], spec.link_zono_gen[i])
        meshes.append(tri)
    return MeshOracle(meshes)
