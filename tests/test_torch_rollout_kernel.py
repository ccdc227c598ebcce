"""The rollout kernel's wrapper on the CPU (`sim/rollout_kernel.py`).

- ``pack`` lays out the spec constants, the true parameters and the iLQR
  gains so that ``unpack_spec`` / ``unpack_world`` give them back exactly,
  for the Kinova and the planar 2-, 4- and 6-link arms.
- Each chain's kernel instantiation, and the move's operation count and
  chain of dependent operations (the bound), pinned; `bench_rollout`'s
  variants of the source find the statements they change.
- ``rollout`` on the CPU is ``rollout_plain`` to the bit and launches
  nothing; a CUDA request without a card raises, and the kernel's wrapper
  never runs on CPU tensors (no fallback); a chain longer than the kernel's
  compile-time joint bound raises.
- The kernel source itself, compiled by the host compiler through a shim
  that runs each block's eight warps as 256 fibers on one host thread (a
  fiber runs until it waits at a barrier), the block's named barriers
  (``bar_sync`` / ``bar_arrive``) and each warp's ``__syncwarp`` as
  barriers and ``__shfl_sync`` through a per-warp exchange row, against
  ``rollout_plain`` on the CPU (the kernel has no interpret mode; on the
  card `tests/test_torch_rollout_cuda.py` holds the real build): the
  Kinova through its own instantiation, the planar 2-, 4- and 6-link arms
  through the run-time one.  A launch whose threads all wait fails with an
  error instead of ending the process.  Float64
  within 1e-12 on the end state and 1e-10 of each log
  field's largest magnitude, float32 within 1e-5 rad and 1e-4 rad/s and 1e-4
  of the torques' largest magnitude: the host compiler forms no FMAs, so the
  two differ in the order of a few sums only.

The JAX parity of the plain path is `test_torch_agent.py`'s.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from armour_tpu_torch import bench_rollout
from armour_tpu_torch.config import PlannerConfig, SimConfig
from armour_tpu_torch.control.ilqr import tvlqr_gain_schedule
from armour_tpu_torch.dynamics.rnea import link_constants
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.robots.planar import planar_arm_spec
from armour_tpu_torch.sim import rollout_kernel as rk
from armour_tpu_torch.sim.agent import (
    CONTROLLERS,
    TrajParams,
    TrueParams,
    rollout,
    rollout_plain,
    traj_eval,
)

SPECS = {"kinova": kinova_gen3_spec, "planar2": lambda: planar_arm_spec(2),
         "planar6": lambda: planar_arm_spec(6), "planar4": lambda: planar_arm_spec(4)}
STEP = SimConfig().plant_dt


def _inputs(spec, B=3, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    nf, n = spec.n_factors, spec.n_joints
    t = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    q0, qd0 = rng.uniform(-1, 1, (B, nf)), rng.uniform(-0.3, 0.3, (B, nf))
    traj = TrajParams(t(q0), t(qd0), t(rng.uniform(-0.5, 0.5, (B, nf))),
                      t(rng.uniform(-0.2, 0.2, (B, nf))), t(rng.uniform(0.0, 0.6, B)))
    true = TrueParams(t(rng.uniform(0.9, 1.1, (B, n))), t(rng.uniform(0.9, 1.1, (B, n))))
    q = t(q0 + rng.normal(scale=1e-3, size=q0.shape))
    return q, t(qd0), traj, true, rng


def _bits(x):
    return x.contiguous().view({torch.float64: torch.int64, torch.float32: torch.int32}[x.dtype])


@pytest.mark.parametrize("name", list(SPECS))
def test_pack_round_trips_spec_and_true_params(name):
    spec = SPECS[name]()
    q, qd, traj, true, _ = _inputs(spec)
    packed = rk.pack(spec, q, qd, traj, true)
    n, nf = spec.n_joints, spec.n_factors
    assert packed.spec.shape == (rk.SPEC_LEN,) and packed.ispec.dtype == torch.int32
    assert packed.world.shape == (3, rk.WORLD_LEN) and packed.world.is_contiguous()
    got = rk.unpack_spec(packed, n)
    nominal = link_constants(spec, q)
    assert (got["n_joints"], got["n_factors"]) == (n, nf)
    assert got["axes"] == spec.axes.tolist()
    assert got["continuous"] == spec.continuous_joints.tolist()
    for key in ("fixed", "trans", "com", "mass", "inertia", "armature", "damping"):
        assert torch.equal(got[key], getattr(nominal, key)), key
    scalars = (spec.gravity, spec.kr, spec.alpha, spec.v_max, spec.mass_uncertainty,
               spec.inertia_uncertainty)
    assert [got[k] for k in rk.SCALARS] == list(scalars)
    world = rk.unpack_world(packed, n)
    assert torch.equal(world["q"], q) and torch.equal(world["qd"], qd)
    for key in TrajParams._fields:
        assert torch.equal(world[key], getattr(traj, key)), key
    # the true parameters exactly as the plain version forms them
    assert torch.equal(world["mass"], nominal.mass * true.mass_scale)
    assert torch.equal(world["inertia"], nominal.inertia * true.inertia_scale[..., None, None])
    # the padding stays zero
    assert not bool(packed.world[:, rk.W_Q + nf:rk.W_QD].any())


@pytest.mark.parametrize("name", list(SPECS))
def test_pack_round_trips_gains_and_noise(name):
    spec = SPECS[name]()
    q, qd, traj, true, rng = _inputs(spec, dtype=torch.float64)
    nf = spec.n_factors
    K, _ = tvlqr_gain_schedule(spec, lambda t: traj_eval(traj, t, 1.0, "bernstein", 0.05), 0.05,
                               0.01, device="cpu")
    assert K.shape == (3, 5, nf, 2 * nf)
    assert torch.equal(rk.pack_gains(K, (3,)), K)
    lead = (3, 2)
    K2 = K[:, None].expand(3, 2, 5, nf, 2 * nf)
    flat = rk.pack_gains(K2, lead)
    assert flat.shape == (6, 5, nf, 2 * nf) and torch.equal(flat.view(3, 2, 5, nf, 2 * nf), K2)
    noise = torch.as_tensor(rng.normal(size=(4, 2, 3, 2, nf)))
    packed = rk.pack_noise(noise, lead, nf)
    assert packed.shape == (4, 2, 6, nf) and torch.equal(packed.view(noise.shape), noise)
    # one noise row for every world broadcasts
    assert torch.equal(rk.pack_noise(noise[:, :, :1, :1], lead, nf)[:, :, 5], noise[:, :, 0, 0])


@pytest.mark.parametrize("controller", ["robust", "ilqr"])
def test_rollout_on_cpu_is_the_plain_version(controller):
    spec = kinova_gen3_spec()
    q, qd, traj, true, rng = _inputs(spec)
    sim = dataclasses.replace(SimConfig(), t_move=30 * STEP)
    noise = torch.as_tensor(rng.normal(scale=1e-4, size=(30, 2, 3, 7)))
    rk.reset_launch_counts()
    a = rollout(spec, sim, q, qd, traj, true, noise=noise, controller=controller, device="cpu")
    b = rollout_plain(spec, sim, q, qd, traj, true, noise=noise, controller=controller, device="cpu")
    assert rk.launch_counts() == {"fused_rollout": 0}
    assert torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(_bits(a[1]), _bits(b[1]))
    for x, y in zip(a[2], b[2]):
        assert torch.equal(_bits(x), _bits(y))


def test_cuda_request_without_card_raises():
    spec = kinova_gen3_spec()
    q, qd, traj, true, _ = _inputs(spec)
    sim = dataclasses.replace(SimConfig(), t_move=4 * STEP)
    rk.reset_launch_counts()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rollout(spec, sim, q, qd, traj, true, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rk.fused_rollout(spec, sim, q, qd, traj, true)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.fused_rollout(spec, sim, q, qd, traj, true, device="cpu")
    with pytest.raises(ValueError, match="unknown controller"):
        rollout(spec, sim, q, qd, traj, true, controller="bang-bang", device="cpu")
    assert rk.launch_counts() == {"fused_rollout": 0}


def test_joint_bound_raises():
    spec = planar_arm_spec(rk.MAXJ + 1)
    q, qd, traj, true, _ = _inputs(spec)
    with pytest.raises(ValueError, match=f"at most {rk.MAXJ} bodies"):
        rk.pack(spec, q, qd, traj, true)
    sim = dataclasses.replace(SimConfig(), t_move=4 * STEP)
    with pytest.raises(ValueError, match=f"at most {rk.MAXJ} bodies"):
        rk.fused_rollout(spec, sim, q, qd, traj, true, device="cpu")
    # the bound itself packs
    rk.pack(planar_arm_spec(rk.MAXJ), *_inputs(planar_arm_spec(rk.MAXJ))[:4])


def test_each_chain_takes_its_instantiation():
    """The Kinova takes the kernel compiled for its joint count; any other
    chain the one with a run-time joint count."""
    assert [rk.instantiation(SPECS[k]()) for k in ("kinova", "planar2", "planar6", "planar4")] \
        == [7, 0, 0, 0]
    assert rk.SPECIALISED == (7,) and rk.INSTANTIATIONS == 4


def test_the_bound_does_not_move_with_the_design():
    """The yardstick of the move: the operations of the Kinova's robust
    Bezier move (44,730 per world and step) and its chain of dependent
    operations per step (1,205) count the work, whatever the layout."""
    spec = kinova_gen3_spec()
    assert rk.operation_count(spec, "robust", "bernstein", 1000, 128) == 44_730 * 1000 * 128
    assert rk.dependent_ops_per_step(spec) == 1205


def test_bench_rollout_variants_find_their_statements():
    """`bench_rollout`'s copies of the source (the clock64() probes after
    fixed statements, the Kinova's launch taken out) find each statement
    once in the tree's source, so that a card call does not fail on them."""
    src = rk.SOURCE.read_text()
    probed = bench_rollout.probed_source(src)
    assert all(f"ARMOUR_PROBE({k});" in probed for k in range(len(bench_rollout.PROBES)))
    run_time = bench_rollout.run_time_source(src)
    assert "rollout_kernel<S, 7><<<" not in run_time and "rollout_kernel<S, 0><<<" in run_time


# ---------------------------------------------------------------------------
# the kernel source on the host compiler
# ---------------------------------------------------------------------------

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <functional>
#include <ucontext.h>
#include <vector>
using std::min;
using namespace std;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim_t { int x; };
// A block's threads run as fibers on one host thread, in turn: a thread runs
// until it waits at a barrier (or ends), then the next one that can run does.
struct emu_block_t {
  int threads = 0, cur = 0, deadlock = 0;
  std::vector<ucontext_t> ctx;
  std::vector<char> waiting, done;
  std::vector<char> stacks;
  ucontext_t host;
  std::function<void()> fn;
};
extern dim_t threadIdx, blockIdx;
extern emu_block_t emu;
inline void emu_next() {  // hand the host thread to the next thread that can run
  const int me = emu.cur;
  for (int k = 1; k <= emu.threads; ++k) {
    const int t = (me + k) % emu.threads;
    if (emu.waiting[t] || emu.done[t]) continue;
    if (t == me) return;
    emu.cur = threadIdx.x = t;
    if (emu.done[me]) setcontext(&emu.ctx[t]);
    swapcontext(&emu.ctx[me], &emu.ctx[t]);
    return;
  }
  for (int t = 0; t < emu.threads; ++t)
    if (!emu.done[t]) emu.deadlock = 1;  // every thread waits: the launch fails
  setcontext(&emu.host);
}
// a barrier of the block: its phase ends when `count` threads have arrived;
// an arriving thread waits for that (bar.sync) or goes on (bar.arrive)
struct emu_barrier_t {
  int arrived = 0;
  std::vector<int> waiters;
  void arrive(int count, bool wait) {
    if (++arrived == count) {
      arrived = 0;
      for (int t : waiters) emu.waiting[t] = 0;
      waiters.clear();
      return;
    }
    if (!wait) return;
    waiters.push_back(emu.cur);
    emu.waiting[emu.cur] = 1;
    emu_next();
  }
};
extern emu_barrier_t emu_bar[16], emu_warp_bar[32];
extern double emu_lanes[32][32];  // per warp, the exchange row of __shfl_sync
template <int ID, int COUNT> inline void bar_sync() { emu_bar[ID].arrive(COUNT, true); }
template <int ID, int COUNT> inline void bar_arrive() { emu_bar[ID].arrive(COUNT, false); }
inline void __syncthreads() { emu_bar[0].arrive(emu.threads, true); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar[threadIdx.x / 32].arrive(32, true); }
template <typename T> inline T __shfl_sync(unsigned, T v, int src) {
  double* row = emu_lanes[threadIdx.x / 32];
  row[threadIdx.x % 32] = (double)v;
  __syncwarp();
  const T out = (T)row[src];
  __syncwarp();
  return out;
}
inline int cudaGetLastError() {  // a deadlocked launch fails, as a hung one would time out
  const int err = emu.deadlock;
  emu.deadlock = 0;
  return err;
}
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __restrict__
inline void emu_entry() {
  emu.fn();
  emu.done[emu.cur] = 1;
  emu_next();
}
inline void emu_launch(int B, int threads, std::function<void()> fn) {  // blocks in turn
  const size_t stack = 1 << 18;
  emu.threads = threads;
  emu.fn = fn;
  emu.ctx.resize(threads);
  emu.stacks.resize(stack * threads);
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    emu.waiting.assign(threads, 0);
    emu.done.assign(threads, 0);
    for (auto& bar : emu_bar) bar = emu_barrier_t();  // a block's barriers start empty
    for (auto& bar : emu_warp_bar) bar = emu_barrier_t();
    for (int t = 0; t < threads; ++t) {
      getcontext(&emu.ctx[t]);
      emu.ctx[t].uc_stack.ss_sp = emu.stacks.data() + stack * t;
      emu.ctx[t].uc_stack.ss_size = stack;
      emu.ctx[t].uc_link = nullptr;
      makecontext(&emu.ctx[t], emu_entry, 0);
    }
    emu.cur = threadIdx.x = 0;
    swapcontext(&emu.host, &emu.ctx[0]);
    if (emu.deadlock) return;
  }
}
"""


def _host_library(root, src: str):
    """``src`` compiled by g++ against the shim, as a shared library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (the mesh oracle's compiler)")
    (root / "cuda_runtime.h").write_text(_SHIM)
    (root / "host.cpp").write_text(
        '#include "cuda_runtime.h"\ndim_t threadIdx, blockIdx;\nemu_block_t emu;\n'
        "emu_barrier_t emu_bar[16], emu_warp_bar[32];\ndouble emu_lanes[32][32];\n" + src)
    out = root / "host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-fPIC", "-shared", f"-I{root}", "-o", str(out),
                    str(root / "host.cpp")], check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    src = rk.SOURCE.read_text()
    # one launch per chain instantiation, each serving every controller
    src, n = re.subn(r"(rollout_kernel<S, \w+>)<<<B, THREADS, 0, stream>>>\(ARMOUR_ROLLOUT_ARGS\)",
                     r"emu_launch(B, THREADS, [&] { \1(ARMOUR_ROLLOUT_ARGS); })", src)
    assert n == len(rk.SPECIALISED) + 1
    return rk.bind(_host_library(tmp_path_factory.mktemp("rollout_host"), src))


def test_host_shim_fails_a_deadlocked_launch(tmp_path):
    """A block whose threads all wait at a barrier that too few reach makes
    the launch fail, and the next launch runs."""
    lib = ctypes.CDLL(str(_host_library(tmp_path, r"""
__global__ void hang(int* out) { bar_sync<1, 64>(); out[threadIdx.x] = 1; }
__global__ void meet(int* out) { bar_sync<1, 32>(); out[threadIdx.x] = 1; }
extern "C" int run(int wait_all, int* out) {
  if (wait_all) emu_launch(1, 32, [&] { hang(out); });
  else emu_launch(2, 32, [&] { meet(out); });
  return cudaGetLastError();
}
""")))
    out = (ctypes.c_int * 32)()
    assert lib.run(1, out) != 0 and sum(out) == 0
    assert lib.run(0, out) == 0 and sum(out) == 32


def _host_rollout(lib, spec, sim, q, qd, traj, true, noise, controller, traj_type):
    """The wrapper's launch on CPU buffers, through the host build."""
    dtype, nf = q.dtype, spec.n_factors
    n_steps = int(round(sim.t_move / sim.plant_dt))
    log_every = max(1, int(round(sim.check_dt / sim.plant_dt)))
    packed = rk.pack(spec, q, qd, traj, true)
    B = packed.world.shape[0]
    noise = rk.pack_noise(noise, packed.lead, nf)
    gains, n_knots = None, 0
    if controller == "ilqr":
        K, _ = tvlqr_gain_schedule(spec, lambda t: traj_eval(traj, t, 1.0, traj_type, sim.t_move),
                                   sim.t_move, sim.check_dt, device="cpu", dtype=dtype)
        gains = rk.pack_gains(K, packed.lead)
        n_knots = gains.shape[1]
    n_log = len(range(0, n_steps, log_every))
    q_end, qd_end = torch.empty((B, nf), dtype=dtype), torch.empty((B, nf), dtype=dtype)
    logs = torch.empty((5, B, n_log, nf), dtype=dtype)
    err = lib.armour_rollout(
        rk._DTYPE_CODE[dtype], CONTROLLERS.index(controller), packed.spec.data_ptr(),
        packed.ispec.data_ptr(), packed.world.data_ptr(), noise.data_ptr(),
        None if gains is None else gains.data_ptr(), B, spec.n_joints, nf, n_steps, log_every,
        n_knots, sim.plant_dt, sim.plant_dt / sim.check_dt, 1.0, sim.t_move, int(traj_type == "orig"),
        q_end.data_ptr(), qd_end.data_ptr(), *(logs[j].data_ptr() for j in range(5)), None)
    assert err == 0
    return q_end, qd_end, logs


@pytest.mark.parametrize("name,controller,traj_type,dtype", [
    ("kinova", "robust", "bernstein", torch.float64),
    ("kinova", "robust", "orig", torch.float32),
    ("kinova", "ilqr", "orig", torch.float64),
    ("kinova", "nominal", "bernstein", torch.float32),
    ("planar2", "pid", "bernstein", torch.float64),
    ("planar6", "althoff", "orig", torch.float64),
    ("planar4", "robust", "bernstein", torch.float64),
])
def test_kernel_source_on_the_host_matches_plain(host_build, name, controller, traj_type, dtype):
    spec = SPECS[name]()
    q, qd, traj, true, rng = _inputs(spec, dtype=dtype)
    steps = 40                                   # two log rows per check_dt
    sim = dataclasses.replace(SimConfig(), t_move=steps * STEP, check_dt=20 * STEP)
    noise = torch.as_tensor(rng.normal(scale=1e-4, size=(steps, 2, 3, spec.n_factors)), dtype=dtype)
    want = rollout_plain(spec, sim, q, qd, traj, true, noise=noise, controller=controller,
                         traj_type=traj_type, device="cpu", dtype=dtype)
    q_end, qd_end, logs = _host_rollout(host_build, spec, sim, q, qd, traj, true, noise,
                                        controller, traj_type)
    f64 = dtype == torch.float64
    assert float((q_end - want[0]).abs().max()) <= (1e-12 if f64 else 1e-5)
    assert float((qd_end - want[1]).abs().max()) <= (1e-12 if f64 else 1e-4)
    for j, name_ in enumerate(("q", "qd", "q_ref", "qd_ref", "u")):
        ref = getattr(want[2], name_)
        assert logs[j].shape == ref.shape == (3, 2, spec.n_factors)
        rel = float((logs[j] - ref).abs().max() / ref.abs().max())
        assert rel <= (1e-10 if f64 else 1e-4), (name_, rel)
