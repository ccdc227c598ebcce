"""The collision bank pass: CUDA kernels for Hopper and their plain versions.

Three entry points, one CUDA source (`armour_tpu_torch/csrc/collision_bank.cu`),
replacing the Pallas TPU kernels of `armour_tpu/collision/pallas_kernel.py`
(the single-start one launches the multi-start kernel at S = 1):

| entry point                        | replaces (pallas_kernel.py)            |
| `fused_collision_value_jac_multi`  | `fused_collision_value_jac_multi` :153 |
| `fused_collision_values_multi`     | `fused_collision_values_multi` :214    |
| `fused_collision_value_jac`        | `fused_collision_value_jac` :71        |

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors go to the plain PyTorch version beside it (the batched form of the
JAX ``impl="xla"`` pipeline, `zonotope.py:175-185`, `:227-256`); CUDA
tensors go to the kernel, or the wrapper raises.  There is no fallback.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.  Any
number of starts is one launch, as the Pallas kernels take any S in one
``pallas_call``: above 4 starts with the Jacobian (16 without) the kernel
splits them into start groups, each writing its starts at their own
offsets in the outputs.  With the Jacobian a group holds 4 starts and is a
block, and the blocks of one tile stream the same bank side by side; values
only, groups of up to 16 starts whose sizes differ by at most one share one
block and read each pair of the tile once for all starts.

A launch takes one of two paths, each a kernel template of the source.
The streaming path (`bank_pass`) streams the bank through shared memory
with Hopper's bulk asynchronous copies when the slab's rows are 16-byte
aligned, T divides 128 and the obstacle count is a multiple of the
obstacles a thread owns (4 at the planner's shapes: buckets 8, 16, 40 and
T = 128 all qualify); other shapes take scalar loads inside the same
kernel.  The small-grid path (`bank_pass_small`) serves banks whose
streaming grid cannot fill the card (the batch-1 and grasp plans): one
obstacle per thread, the whole tile of all pairs in shared memory at once,
the pair axis split over the warps of a block.  The launch picks the path
(``launch_path`` of `csrc/collision_bank_grid.cuh`, the one model of both
grids) from the bank's shape and the card's SM count, and reports the path
it took; both give the same bits.  The source's header comment has the
design and what bounds it.

The library is built at first use with ``nvcc`` into
``armour_tpu_torch/build/`` (a plain C interface, loaded with ctypes; about
10-25 s).  ``build(verbose=True)`` returns the ``-Xptxas -v`` log and
`ptxas_summary` turns it into registers and spill bytes per instantiation.
`armour_tpu_torch.bench_bank` times this source beside another one (an
earlier commit's) in one process.  Layouts are those of the kernel source's
header comment.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "collision_bank.cu"
GRID_SOURCE = _PKG / "csrc" / "collision_bank_grid.cpp"   # the grid model, for the host compiler
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
PATHS = {"stream": 0, "small": 1}   # the C entry points' path argument, and what they report
_AUTO = 2                           # the path argument that lets the launch choose
_START = -1e30  # the running max's start value


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------

def pieces(A, dpos, dneg, c):
    """The 2P affine separation pieces vp = A.c - dpos, vn = -A.c - dneg:
    each (B, S, P, L, O, T) for A (B,P,3,L,O,T) and c (B,S,3,L,T).  A bf16
    bank is upcast to the offsets' type first (``torch`` does not promote
    as ``jnp`` does)."""
    Af = A.to(dpos.dtype)[:, None]                       # (B, 1, P, 3, L, O, T)
    cc = c[:, :, None, :, :, None, :]                    # (B, S, 1, 3, L, 1, T)
    Ac = Af[:, :, :, 0] * cc[:, :, :, 0] + Af[:, :, :, 1] * cc[:, :, :, 1] + Af[:, :, :, 2] * cc[:, :, :, 2]
    return Ac - dpos[:, None], -Ac - dneg[:, None]


def _piece_max(vp, vn):
    """The kernel's running max over the pieces (dim 2): start at -1e30,
    first maximum wins, a piece with a NaN never wins.  Returns best
    (B,S,1,L,O,T), its first index, and whether any piece beat -1e30."""
    both = torch.where(torch.isnan(vp) | torch.isnan(vn), -torch.inf, torch.maximum(vp, vn))
    best, idx = torch.max(both, dim=2, keepdim=True)     # first maximum, like jnp.argmax
    won = best > _START
    return torch.where(won, best, _START), idx, won


def tie_mask(A, dpos, dneg, c, tol=1e-5):
    """(B, S, L, O, T): slots whose best of the 2P pieces (pairs with a NaN
    left out) leads the second by more than ``tol``.  Elsewhere the winner
    is a tie and either normal is a valid subgradient, so Jacobians are
    compared only here."""
    vp, vn = pieces(A, dpos, dneg, c)
    bad = torch.isnan(vp) | torch.isnan(vn)              # pairs that never win
    both = torch.stack([vp.masked_fill(bad, -torch.inf), vn.masked_fill(bad, -torch.inf)],
                       dim=2).flatten(2, 3)                # (B, S, 2P, L, O, T)
    top2 = torch.topk(both, 2, dim=2).values
    return (top2[:, :, 0] - top2[:, :, 1]) > tol


def value_jac_multi_plain(A, dpos, dneg, c, dc):
    """Plain version of `fused_collision_value_jac_multi`:
    g (B,S,L,O,T), J (B,S,n,L,O,T)."""
    vp, vn = pieces(A, dpos, dneg, c)
    best, idx, won = _piece_max(vp, vn)
    sign = torch.where(torch.gather(vp >= vn, 2, idx), -1.0, 1.0).to(dpos.dtype)
    sign = torch.where(won, sign, 0.0)
    Af = A.to(dpos.dtype)[:, None].expand(-1, c.shape[1], -1, -1, -1, -1, -1)
    sel = [sign * torch.gather(Af[:, :, :, k], 2, idx) for k in range(3)]  # (B, S, 1, L, O, T)
    d = dc[..., None, :]                                 # (B, S, n, 3, L, 1, T)
    J = sel[0] * d[:, :, :, 0] + sel[1] * d[:, :, :, 1] + sel[2] * d[:, :, :, 2]
    return -best[:, :, 0], J


def values_multi_plain(A, dpos, dneg, c):
    """Plain version of `fused_collision_values_multi`: g (B,S,L,O,T)."""
    return -_piece_max(*pieces(A, dpos, dneg, c))[0][:, :, 0]


def value_jac_plain(A, dpos, dneg, c, dc):
    """Plain version of `fused_collision_value_jac`: c (B,3,L,T),
    dc (B,n,3,L,T) -> g (B,L,O,T), J (B,n,L,O,T)."""
    g, J = value_jac_multi_plain(A, dpos, dneg, c[:, None], dc[:, None])
    return g[:, 0], J[:, 0]


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the collision kernels are built from "
                       f"{SOURCE} at first use and need the CUDA toolkit")


def library_path(source: Path = SOURCE, extra_flags: tuple = ()) -> Path:
    """Where the built library lives; the name carries a hash of the source,
    of every header beside it and of the flags, so an edit never loads a
    stale build."""
    source = Path(source)
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    for f in (source, *sorted(source.parent.glob("*.cuh"))):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, source: Path = SOURCE, extra_flags: tuple = ()) -> dict:
    """Compile the kernels unless the library for this source exists.
    Returns {"path", "seconds", "built", "log"}; ``verbose`` adds
    ``-Xptxas -v`` (registers, spills) to the log.  ``source`` and
    ``extra_flags`` build another version of the same C interface (an
    earlier commit's source, say) for `bench_bank` to time beside this one."""
    out = library_path(source, extra_flags)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True, "log": proc.stderr}


_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32", "d": "f64"}


def kernel_name(mangled: str) -> str:
    """The readable name of an instantiation of ``bank_pass``,
    ``bank_pass_small`` or ``rollout_kernel`` (any other name as it is):
    ``bank_pass<A type,offsets' type,S<=bound,values|value+jac[,G groups]>``,
    G the most start groups a block of the instantiation holds side by side."""
    m = re.search(r"(bank_pass(?:_small)?)I(13__nv_bfloat16|f|d)(f|d)Li(\d+)ELb([01])E"
                  r"(?:Li(\d+)E)?", mangled)
    if m:  # bank_pass[_small]<A type, offsets' type, start bound, with Jacobian[, groups]>
        groups = f",{m[6]} groups" if m[6] and m[6] != "1" else ""
        return (f"{m[1]}<{_TYPES[m[2]]},{_TYPES[m[3]]},S<={m[4]},"
                f"{'value+jac' if m[5] == '1' else 'values'}{groups}>")
    m = re.search(r"rollout_kernelI(f|d)Li(\d+)E", mangled)
    if m:  # rollout_kernel<scalar, template integer>
        return f"rollout_kernel<{_TYPES[m[1]]},{m[2]}>"
    return mangled


def ptxas_summary(log: str) -> list:
    """One row per kernel of a ``-Xptxas -v`` log: {"kernel", "registers",
    "spill_stores", "spill_loads", "smem_bytes", "barriers"} (spills in bytes
    per thread, shared memory in bytes per block), the instantiations of
    ``bank_pass``, ``bank_pass_small`` and ``rollout_kernel`` under a
    readable name (`kernel_name`)."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "bytes spill stores" in line:
            spill = tuple(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line and name:
            smem = re.search(r"(\d+) bytes smem", line)
            bars = re.search(r"used (\d+) barriers", line)
            rows.append({"kernel": name, "registers": int(line.split("Used")[1].split()[0]),
                         "spill_stores": spill[0], "spill_loads": spill[1],
                         "smem_bytes": int(smem[1]) if smem else 0,
                         "barriers": int(bars[1]) if bars else None})
            name, spill = None, (0, 0)
    return rows


@functools.lru_cache(maxsize=None)
def grid_model() -> ctypes.CDLL:
    """The launch geometry of `csrc/collision_bank_grid.cuh` (each path's
    grid and the choice between them), built with the host compiler into
    the build directory at first use: the model the kernels launch on, asked
    without a card (`csrc/collision_bank_grid.cpp` has its C interface)."""
    out = library_path(GRID_SOURCE)
    if not out.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError(f"no C++ compiler found: the grid model is built from {GRID_SOURCE}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", tmp,
                               str(GRID_SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"the grid model did not build ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.grid_stream_blocks.restype = ctypes.c_longlong
    return lib


def stream_grid(S: int, L: int, O: int, T: int, jac: bool, o_size: int) -> dict:
    """The streaming path's grid for one world, as the launch computes it:
    the start groups and their sizes, how many share a block, the template
    bound on a group's starts and the most groups a block of that
    instantiation holds (the instantiation), the obstacles a thread owns,
    threads per block and blocks."""
    m = grid_model()
    groups, bound = m.grid_stream_groups(S, jac, o_size), m.grid_stream_bound(S, jac, o_size)
    in_block = m.grid_block_groups(S, jac, o_size)
    firsts = [m.grid_group_start(k, S, groups, bound, in_block > 1) for k in range(groups + 1)]
    return {"groups": groups, "starts": [b - a for a, b in zip(firsts, firsts[1:])],
            "block_groups": in_block, "bound": bound,
            "instantiated_groups": m.grid_most_block_groups(o_size) if in_block > 1 else 1,
            "obstacles_per_thread": m.grid_obstacles_per_thread(bound, jac, o_size, in_block > 1),
            "threads": 128 * in_block, "blocks": m.grid_stream_blocks(S, L, O, T, jac, o_size)}


def bind(path) -> ctypes.CDLL:
    """Load a built library and declare its entry points' C types."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, out = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.armour_collision_value_jac_multi.argtypes = [
        ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        i32, out, ptr]
    lib.armour_collision_values_multi.argtypes = [
        ptr, i32, ptr, ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, out, ptr]
    lib.armour_collision_empty.argtypes = [ptr]
    for fn in (lib.armour_collision_value_jac_multi, lib.armour_collision_values_multi,
               lib.armour_collision_empty):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build()["path"])


def _raise_on(err: int, name: str):
    if err != 0:
        try:
            rt = torch.cuda.cudart()
            msg = rt.cudaGetErrorString(rt.cudaError(err))
        except (RuntimeError, AttributeError, TypeError, ValueError):
            msg = f"cudaError {err}"
        raise RuntimeError(f"{name}: kernel launch failed: {msg}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"collision kernels: tensors on {sorted(str(t.device) for t in tensors)}; "
                     "all must be on the CPU or all on one CUDA device")


def _check_bank(A, dpos, dneg):
    if A.dim() != 6 or A.shape[2] != 3:
        raise ValueError(f"A must be (B,P,3,L,O,T), got {tuple(A.shape)}")
    B, P, _, L, O, T = A.shape
    for name, t in (("dpos", dpos), ("dneg", dneg)):
        if tuple(t.shape) != (B, P, L, O, T):
            raise ValueError(f"{name} must be {(B, P, L, O, T)}, got {tuple(t.shape)}")
    if dpos.dtype not in (torch.float32, torch.float64) or dneg.dtype != dpos.dtype:
        raise TypeError(f"offsets must share float32 or float64, got {dpos.dtype}, {dneg.dtype}")
    if A.dtype not in _DTYPE_CODE or A.element_size() > dpos.element_size():
        raise TypeError(f"A dtype {A.dtype} not supported with {dpos.dtype} offsets")
    return B, P, L, O, T


def _check_starts(name, t, shape, dtype):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _check_contiguous(*tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("collision kernels take contiguous tensors only")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_value_jac_multi(A, dpos, dneg, c, dc, lib=None, path=None):
    """Launch the value + Jacobian kernel (of ``lib``, else of this source's
    library) on checked CUDA tensors on the current device; the caller counts
    the launch.  Returns g, J and the path launched ("stream" or "small").
    ``path`` forces one for the tests and `bench_bank` (a bank that cannot
    take the small-grid path streams all the same); None lets the launch
    choose."""
    lib = lib or _lib()
    B, P, _, L, O, T = A.shape
    S, n = dc.shape[1], dc.shape[2]
    g = torch.empty((B, S, L, O, T), dtype=dpos.dtype, device=dpos.device)
    J = torch.empty((B, S, n, L, O, T), dtype=dpos.dtype, device=dpos.device)
    ran = ctypes.c_int(-1)
    err = lib.armour_collision_value_jac_multi(
        _ptr(A), _DTYPE_CODE[A.dtype], _ptr(dpos), _ptr(dneg), _DTYPE_CODE[dpos.dtype],
        _ptr(c), _ptr(dc), _ptr(g), _ptr(J), B, P, L, O, T, S, n,
        _AUTO if path is None else PATHS[path], ctypes.byref(ran), _stream())
    _raise_on(err, "armour_collision_value_jac_multi")
    return g, J, list(PATHS)[ran.value]


def _launch_values_multi(A, dpos, dneg, c, lib=None, path=None):
    """Launch the values-only kernel likewise: returns g and the path."""
    lib = lib or _lib()
    B, P, _, L, O, T = A.shape
    S = c.shape[1]
    g = torch.empty((B, S, L, O, T), dtype=dpos.dtype, device=dpos.device)
    ran = ctypes.c_int(-1)
    err = lib.armour_collision_values_multi(
        _ptr(A), _DTYPE_CODE[A.dtype], _ptr(dpos), _ptr(dneg), _DTYPE_CODE[dpos.dtype],
        _ptr(c), _ptr(g), B, P, L, O, T, S, _AUTO if path is None else PATHS[path],
        ctypes.byref(ran), _stream())
    _raise_on(err, "armour_collision_values_multi")
    return g, list(PATHS)[ran.value]


def _launch_empty(lib=None):
    """Launch the library's empty kernel (one warp): the floor under any launch."""
    _raise_on((lib or _lib()).armour_collision_empty(_stream()), "armour_collision_empty")


def fused_collision_value_jac_multi(A, dpos, dneg, c, dc):
    """Value + k-Jacobian for any S starts in one launch.

    A (B,P,3,L,O,T), dpos/dneg (B,P,L,O,T), c (B,S,3,L,T), dc (B,S,n,3,L,T)
    -> g (B,S,L,O,T), J (B,S,n,L,O,T)."""
    B, P, L, O, T = _check_bank(A, dpos, dneg)
    S, n = dc.shape[1], dc.shape[2]
    _check_starts("c", c, (B, S, 3, L, T), dpos.dtype)
    _check_starts("dc", dc, (B, S, n, 3, L, T), dpos.dtype)
    if _on_cpu(A, dpos, dneg, c, dc):
        return value_jac_multi_plain(A, dpos, dneg, c, dc)
    _check_contiguous(A, dpos, dneg, c, dc)
    fused_collision_value_jac_multi.launches += 1
    g, J, _ = _launch_value_jac_multi(A, dpos, dneg, c, dc)
    return g, J


def fused_collision_values_multi(A, dpos, dneg, c):
    """Values only for any S starts in one launch (the planner's
    verification pool of 2S + 2 candidates among them): c (B,S,3,L,T)
    -> g (B,S,L,O,T)."""
    B, P, L, O, T = _check_bank(A, dpos, dneg)
    S = c.shape[1]
    _check_starts("c", c, (B, S, 3, L, T), dpos.dtype)
    if _on_cpu(A, dpos, dneg, c):
        return values_multi_plain(A, dpos, dneg, c)
    _check_contiguous(A, dpos, dneg, c)
    fused_collision_values_multi.launches += 1
    return _launch_values_multi(A, dpos, dneg, c)[0]


def fused_collision_value_jac(A, dpos, dneg, c, dc):
    """Value + k-Jacobian for one start: c (B,3,L,T), dc (B,n,3,L,T)
    -> g (B,L,O,T), J (B,n,L,O,T).  The S = 1 launch of the multi-start
    kernel, counted here."""
    B, P, L, O, T = _check_bank(A, dpos, dneg)
    n = dc.shape[1]
    _check_starts("c", c, (B, 3, L, T), dpos.dtype)
    _check_starts("dc", dc, (B, n, 3, L, T), dpos.dtype)
    if _on_cpu(A, dpos, dneg, c, dc):
        return value_jac_plain(A, dpos, dneg, c, dc)
    _check_contiguous(A, dpos, dneg, c, dc)
    fused_collision_value_jac.launches += 1
    g, J, _ = _launch_value_jac_multi(A, dpos, dneg, c[:, None], dc[:, None])
    return g[:, 0], J[:, 0]


KERNELS = (fused_collision_value_jac_multi, fused_collision_values_multi, fused_collision_value_jac)
PLAIN = {
    fused_collision_value_jac_multi: value_jac_multi_plain,
    fused_collision_values_multi: values_multi_plain,
    fused_collision_value_jac: value_jac_plain,
}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
