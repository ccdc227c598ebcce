"""The closed-loop plant rollout as one CUDA kernel for Hopper.

One launch of `armour_tpu_torch/csrc/rollout.cu` advances every world
through all ``n_steps`` RK4 steps of a move, the low-level controller in the
loop, and writes the ``check_dt`` log: the counterpart of the JAX package's
compiled scan (`armour_tpu/sim/agent.py:236`, ``lax.scan`` of ``rk4_step``),
which has no Pallas kernel because XLA fuses the scan's body.  Its plain
version is `sim/agent.py::rollout_plain` (on a card, one CUDA graph of the
step replayed ``n_steps`` times); `sim/agent.py::rollout` takes this kernel
for CUDA tensors and the plain version for CPU tensors.

The kernel runs one block of eight warps per world (the state, the bias
rows, the mass matrix, the controller's passes; the source's header
comment has the layout).  It is compiled once for each chain in
``SPECIALISED`` (a joint count equal to the actuated joint count: the
Kinova), with the joint count a compile-time constant, and once with a
run-time joint count for any other chain (``instantiation`` says which a
spec takes).

``pack`` lays the spec constants, the true parameters, the state and the
trajectory out in the flat buffers the kernel reads (layout: the source's
header comment, mirrored by the constants below and checked against the
library's ``armour_rollout_layout`` when it is loaded); ``unpack_spec`` and
``unpack_world`` invert it.  The joint count is a compile-time bound of the
kernel (``MAXJ`` bodies, fixed ones included): a longer chain raises.

The library is built at first use with ``nvcc`` into the git-ignored
``armour_tpu_torch/build/`` by `collision/kernels.py::build` (the same flags:
no fast math), loaded with ctypes.  There is no fallback: a CUDA request
launches the kernel, and a build or launch error raises.  ``fused_rollout``
counts its launches in ``fused_rollout.launches`` (one per move).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from armour_tpu_torch.collision import kernels
from armour_tpu_torch.config import SimConfig
from armour_tpu_torch.control.ilqr import tvlqr_gain_schedule
from armour_tpu_torch.device import const, resolve_device
from armour_tpu_torch.dynamics.rnea import link_constants
from armour_tpu_torch.robots.spec import RobotSpec
from armour_tpu_torch.sim.agent import CONTROLLERS, RolloutLog, TrajParams, TrueParams, traj_eval
from armour_tpu_torch.utils import graphs

SOURCE = Path(kernels.__file__).resolve().parents[1] / "csrc" / "rollout.cu"

MAXJ = 16  # bodies of the chain, fixed ones included (rollout.cu MAXJ)
SPECIALISED = (7,)  # joint counts with an instantiation of their own (rollout.cu)
INSTANTIATIONS = 2 * (len(SPECIALISED) + 1)  # float32 and float64, and the run-time one
THREADS = 256  # one block of eight warps per world (rollout.cu THREADS)

OFF_FIXED = 0
OFF_TRANS = OFF_FIXED + (MAXJ + 1) * 9
OFF_COM = OFF_TRANS + (MAXJ + 1) * 3
OFF_MASS = OFF_COM + MAXJ * 3
OFF_INERTIA = OFF_MASS + MAXJ
OFF_ARMATURE = OFF_INERTIA + MAXJ * 9
OFF_DAMPING = OFF_ARMATURE + MAXJ
OFF_SCALARS = OFF_DAMPING + MAXJ
SPEC_LEN = OFF_SCALARS + 8
SCALARS = ("gravity", "kr", "alpha", "v_max", "dm", "dI")
ISPEC_LEN = 2 + 2 * MAXJ
W_Q, W_QD, W_Q0, W_QD0, W_QDD0, W_K, W_TOFF, W_MASS = (i * MAXJ for i in range(8))
W_INERTIA = 8 * MAXJ
WORLD_LEN = 17 * MAXJ

_DTYPE_CODE = {torch.float32: 1, torch.float64: 2}


class Packed(NamedTuple):
    """The kernel's inputs: ``spec`` (SPEC_LEN,), ``ispec`` (ISPEC_LEN,)
    int32, ``world`` (B, WORLD_LEN), the worlds' leading shape ``lead``
    (B = its product) and the actuated joint count ``nf``."""

    spec: torch.Tensor
    ispec: torch.Tensor
    world: torch.Tensor
    lead: tuple
    nf: int


def instantiation(spec: RobotSpec) -> int:
    """The joint count of the kernel instantiation ``spec`` takes: its own
    when it is in ``SPECIALISED`` (and every joint is actuated), else 0, the
    instantiation with a run-time joint count."""
    n = spec.n_joints
    return n if n == spec.n_factors and n in SPECIALISED else 0


def check_joint_bound(spec: RobotSpec):
    if spec.n_joints > MAXJ:
        raise ValueError(f"the rollout kernel takes chains of at most {MAXJ} bodies; "
                         f"{spec.name} has {spec.n_joints}")


def spec_rows(spec: RobotSpec):
    """The spec's buffers of the kernel as host arrays: ``spec`` (SPEC_LEN,)
    float64 and ``ispec`` (ISPEC_LEN,) int32."""
    check_joint_bound(spec)
    n, nf = spec.n_joints, spec.n_factors
    s = np.zeros(SPEC_LEN)
    s[OFF_FIXED:OFF_TRANS].reshape(MAXJ + 1, 9)[:n + 1] = np.reshape(spec.fixed_rotations(), (n + 1, 9))
    s[OFF_TRANS:OFF_COM].reshape(MAXJ + 1, 3)[:n + 1] = spec.trans
    s[OFF_COM:OFF_MASS].reshape(MAXJ, 3)[:n] = spec.com
    s[OFF_MASS:OFF_MASS + n] = spec.mass
    s[OFF_INERTIA:OFF_ARMATURE].reshape(MAXJ, 9)[:n] = np.reshape(spec.inertia, (n, 9))
    s[OFF_ARMATURE:OFF_ARMATURE + n] = spec.armature
    s[OFF_DAMPING:OFF_DAMPING + n] = spec.damping
    scalars = (spec.gravity, spec.kr, spec.alpha, spec.v_max, spec.mass_uncertainty,
               spec.inertia_uncertainty)
    s[OFF_SCALARS:OFF_SCALARS + len(scalars)] = scalars
    ispec = np.zeros(ISPEC_LEN, np.int32)
    ispec[0], ispec[1] = n, nf
    ispec[2:2 + n] = spec.axes[:n]
    ispec[2 + MAXJ:2 + MAXJ + nf] = spec.continuous_joints[:nf]
    return s, ispec


def pack(spec: RobotSpec, q, qd, traj: TrajParams, true_params: TrueParams) -> Packed:
    """Lay a rollout's inputs out for the kernel, in the dtype and on the
    device of ``q``.  The true mass and inertia are formed as the plain
    version forms them (nominal times the scale, in that dtype).  The spec's
    buffers depend on the spec, the dtype and the device alone: they are
    made once (`device.const`), so a captured step may pack."""
    s, ispec = spec_rows(spec)
    n, nf = spec.n_joints, spec.n_factors
    dtype, dev = q.dtype, q.device
    nominal = link_constants(spec, q)
    lead = torch.broadcast_shapes(q.shape[:-1], qd.shape[:-1], *(x.shape[:-1] for x in traj[:4]),
                                  traj.t_offset.shape, *(x.shape[:-1] for x in true_params))
    B = 1
    for d in lead:
        B *= d

    w = torch.zeros(lead + (WORLD_LEN,), dtype=dtype, device=dev)
    for off, x in ((W_Q, q), (W_QD, qd), (W_Q0, traj.q0), (W_QD0, traj.qd0),
                   (W_QDD0, traj.qdd0), (W_K, traj.k_actual)):
        w[..., off:off + nf] = x
    w[..., W_TOFF] = traj.t_offset
    w[..., W_MASS:W_MASS + n] = nominal.mass * true_params.mass_scale
    inertia = nominal.inertia * true_params.inertia_scale[..., None, None]
    w[..., W_INERTIA:W_INERTIA + 9 * n] = inertia.reshape(inertia.shape[:-3] + (9 * n,))
    return Packed(const(s, dtype, dev), const(ispec, torch.int32, dev),
                  w.reshape(B, WORLD_LEN).contiguous(), tuple(lead), nf)


def unpack_spec(packed: Packed, n: int) -> dict:
    """The spec constants of a packed buffer, for a chain of ``n`` bodies."""
    s, i = packed.spec, packed.ispec.cpu()
    nf = int(i[1])
    return {
        "n_joints": int(i[0]), "n_factors": nf,
        "axes": i[2:2 + n].tolist(), "continuous": i[2 + MAXJ:2 + MAXJ + nf].bool().tolist(),
        "fixed": s[OFF_FIXED:OFF_TRANS].view(MAXJ + 1, 3, 3)[:n + 1],
        "trans": s[OFF_TRANS:OFF_COM].view(MAXJ + 1, 3)[:n + 1],
        "com": s[OFF_COM:OFF_MASS].view(MAXJ, 3)[:n],
        "mass": s[OFF_MASS:OFF_MASS + n],
        "inertia": s[OFF_INERTIA:OFF_ARMATURE].view(MAXJ, 3, 3)[:n],
        "armature": s[OFF_ARMATURE:OFF_ARMATURE + n],
        "damping": s[OFF_DAMPING:OFF_DAMPING + n],
        **{k: float(s[OFF_SCALARS + j]) for j, k in enumerate(SCALARS)},
    }


def unpack_world(packed: Packed, n: int) -> dict:
    """The per-world fields of a packed buffer, each with the leading shape."""
    w = packed.world.view(packed.lead + (WORLD_LEN,))
    nf = packed.nf
    out = {name: w[..., off:off + nf] for name, off in
           (("q", W_Q), ("qd", W_QD), ("q0", W_Q0), ("qd0", W_QD0), ("qdd0", W_QDD0),
            ("k_actual", W_K))}
    out["t_offset"] = w[..., W_TOFF]
    out["mass"] = w[..., W_MASS:W_MASS + n]
    out["inertia"] = w[..., W_INERTIA:W_INERTIA + 9 * n].reshape(packed.lead + (n, 3, 3))
    return out


def pack_gains(K: torch.Tensor, lead: tuple) -> torch.Tensor:
    """iLQR gains (..., n_knots, nf, 2 nf) broadcast to the worlds' leading
    shape and flattened to (B, n_knots, nf, 2 nf)."""
    K = K.expand(tuple(lead) + K.shape[-3:])
    return K.reshape((-1,) + K.shape[-3:]).contiguous()


def pack_noise(noise: torch.Tensor, lead: tuple, nf: int) -> torch.Tensor:
    """Measurement noise (n_steps, 2, ..., nf) broadcast to the worlds'
    leading shape and flattened to (n_steps, 2, B, nf)."""
    noise = noise.expand(tuple(noise.shape[:2]) + tuple(lead) + (nf,))
    return noise.reshape(noise.shape[:2] + (-1, nf)).contiguous()


# ---------------------------------------------------------------------------
# the work of a move, counted from the kernel source (for its bounds)
# ---------------------------------------------------------------------------

# floating-point operations of the source's primitives
_CROSS, _MUL3, _ADD3, _ABS_MUL3 = 9, 15, 3, 24
_REFERENCE = {"bernstein": 140, "orig": 25}     # per joint and step


def _pass_ops(n: int, nf: int, absolute: bool, moving: bool) -> int:
    """The operations one RNEA pass of `rnea_pass` needs.  A moving pass
    (the plant's bias row, the controller's passes at the measured rates)
    does it all: per joint the forward recursion (three crosses, two sums,
    four rotations), the force and moment terms and the backward step, per
    actuated joint the rate terms and, nominal, the armature and damping
    output.  A pass at zero rates (the plant's mass-matrix columns, the
    robust controller's interval ``M r`` pass) has w = wa = 0 throughout:
    its forward step is one cross, one sum and two rotations (acc, wd), its
    force and moment terms need wd alone, and its rate terms are the unit
    acceleration's sum."""
    if moving:
        forward = 3 * _CROSS + 2 * _ADD3 + 4 * _MUL3
        fn = (3 * _CROSS + 2 * _ADD3 + (1 + 6 + 9 + 2 * _ABS_MUL3) + _CROSS + _ADD3 if absolute
              else 3 * _CROSS + 2 * _ADD3 + 3 + 2 * _MUL3 + _CROSS + _ADD3)
        rate, output = 3 + _CROSS + 2 * _ADD3 + _ADD3 + 3, 4
    else:
        forward = _CROSS + _ADD3 + 2 * _MUL3
        fn = (_CROSS + _ADD3 + (1 + 6 + 3 + _ABS_MUL3) if absolute
              else _CROSS + _ADD3 + 3 + _MUL3)
        rate, output = _ADD3 + 1, 2
    backward = (2 * _ABS_MUL3 + 2 * _CROSS + 6 + 4 * _ADD3 if absolute
                else 2 * _MUL3 + 2 * _CROSS + 4 * _ADD3)
    return n * (forward + fn + backward) + nf * (rate + (0 if absolute else output))


def _solve_ops(nf: int) -> int:
    elim = sum((nf - 1 - j) * (1 + 2 * (nf - j)) for j in range(nf - 1))
    return nf + elim + sum(1 + 2 * j for j in range(nf))


def operation_count(spec: RobotSpec, controller: str, traj_type: str, n_steps: int, B: int) -> int:
    """The floating-point operations one launch needs for B worlds and
    ``n_steps`` steps: per step four plant evaluations (joint rotations, the
    bias row, nf mass-matrix columns at zero rates, the elimination), the
    controller's passes (robust: a nominal and an absolute-value pass at the
    measured rates and both again at zero rates for ``M r``; althoff the
    first two; the others one nominal pass) and its per-joint terms, the
    reference, the noise and the RK4 sums.  sin, cos, division and square
    root count as one operation each."""
    n, nf = spec.n_joints, spec.n_factors
    rotations = nf * (2 + 27 + 18)
    plant = (rotations + _pass_ops(n, nf, False, True) + nf * _pass_ops(n, nf, False, False)
             + _solve_ops(nf))
    moving = _pass_ops(n, nf, False, True) + _pass_ops(n, nf, True, True)
    passes = {"robust": moving + _pass_ops(n, nf, False, False) + _pass_ops(n, nf, True, False),
              "althoff": moving}.get(controller, _pass_ops(n, nf, False, True))
    per_joint = {"robust": 30, "althoff": 20, "nominal": 14, "pid": 12, "ilqr": 8 + 4 * nf}[controller]
    step = 4 * plant + rotations + passes + nf * (per_joint + _REFERENCE[traj_type] + 2 + 28)
    return step * n_steps * B


def dependent_ops_per_step(spec: RobotSpec) -> int:
    """The length of a step's chain of dependent operations (robust
    controller), a model of the source: an RNEA pass is ~9 dependent
    operations per joint forward (the acceleration: two nested crosses, two
    sums, a rotation), ~6 per joint backward and ~8 more; a rotation ~23
    (sin/cos and the product); an elimination ~9 per pivot and ~9 per back
    substitution (a division and a fused product); the controller's norms
    ~40; the RK4 stage sums ~10.  Four plant evaluations and the controller
    run one after the other; the steps too."""
    n, nf = spec.n_joints, spec.n_factors
    rnea = 15 * n + 8
    evaluation = 23 + rnea + 1 + 9 * (nf - 1) + 9 * nf
    return 4 * evaluation + (3 + 23 + rnea + 40) + 10


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> dict:
    """Compile `csrc/rollout.cu` unless its library exists (see
    `collision/kernels.py::build`)."""
    return kernels.build(verbose=verbose, source=SOURCE)


def bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.armour_rollout_layout.argtypes = [ptr]
    lib.armour_rollout.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                   i32, f64, f64, f64, f64, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                   ptr]
    lib.armour_rollout_layout.restype = lib.armour_rollout.restype = i32
    want = (MAXJ, SPEC_LEN, ISPEC_LEN, WORLD_LEN, THREADS, *SPECIALISED)
    layout = (ctypes.c_int * len(want))()
    lib.armour_rollout_layout(ctypes.cast(layout, ctypes.c_void_p))
    if tuple(layout) != want:
        raise RuntimeError(f"{path}: buffer layout {tuple(layout)} differs from the wrapper's {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build()["path"])


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def fused_rollout(spec: RobotSpec, sim: SimConfig, q, qd, traj: TrajParams,
                  true_params: TrueParams, duration: float = 1.0, noise=None,
                  generator: torch.Generator | None = None, controller: str = "robust",
                  traj_type: str = "bernstein", device=None, dtype: torch.dtype = torch.float64):
    """`sim/agent.py::rollout` on CUDA tensors as one kernel launch: the same
    arguments and results (q_end, qd_end, RolloutLog).  The noise is drawn as
    the plain version draws it, and the iLQR gains are the plain version's
    (``tvlqr_gain_schedule``, plain PyTorch, once per rollout)."""
    if controller not in CONTROLLERS:
        raise ValueError(f"unknown controller {controller!r}")
    if traj_type not in ("bernstein", "orig"):
        raise ValueError(f"unknown trajectory type {traj_type!r}")
    check_joint_bound(spec)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the rollout kernel takes CUDA tensors, not {dev}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the rollout kernel takes float32 or float64, not {dtype}")

    def on(*xs):
        return tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in xs)

    q, qd = on(q, qd)
    traj = TrajParams(*on(*traj))
    true_params = TrueParams(*on(*true_params))
    nf = spec.n_factors
    n_steps = int(round(sim.t_move / sim.plant_dt))
    log_every = max(1, int(round(sim.check_dt / sim.plant_dt)))
    dt = sim.plant_dt
    packed = pack(spec, q, qd, traj, true_params)
    lead, B = packed.lead, packed.world.shape[0]

    if noise is not None:
        noise = pack_noise(torch.as_tensor(noise, dtype=dtype, device=dev), lead, nf)
    elif generator is not None and sim.measurement_noise_std > 0.0:
        noise = pack_noise(sim.measurement_noise_std * torch.randn(
            (n_steps, 2) + q.shape, generator=generator, dtype=dtype, device=dev), lead, nf)
    gains, n_knots = None, 0
    if controller == "ilqr":
        K, _ = tvlqr_gain_schedule(
            spec, lambda t: traj_eval(traj, t, duration, traj_type, sim.t_move),
            sim.t_move, sim.check_dt, device=dev, dtype=dtype)
        gains = pack_gains(K, lead)
        n_knots = gains.shape[1]

    n_log = len(range(0, n_steps, log_every))
    q_end = torch.empty((B, nf), dtype=dtype, device=dev)
    qd_end = torch.empty_like(q_end)
    logs = torch.empty((5, B, n_log, nf), dtype=dtype, device=dev)
    lib = _lib()
    fused_rollout.launches += 1
    err = lib.armour_rollout(
        _DTYPE_CODE[dtype], CONTROLLERS.index(controller), packed.spec.data_ptr(),
        packed.ispec.data_ptr(), packed.world.data_ptr(),
        None if noise is None else noise.data_ptr(), None if gains is None else gains.data_ptr(),
        B, spec.n_joints, nf, n_steps, log_every, n_knots, dt, dt / sim.check_dt, float(duration),
        float(sim.t_move), int(traj_type == "orig"), q_end.data_ptr(), qd_end.data_ptr(),
        *(logs[j].data_ptr() for j in range(5)), torch.cuda.current_stream(dev).cuda_stream)
    kernels._raise_on(err, "armour_rollout")
    t = const([i * dt for i in range(0, n_steps, log_every)], dtype, dev)
    log = RolloutLog(t, *(logs[j].reshape(lead + (n_log, nf)) for j in range(5)))
    return q_end.reshape(lead + (nf,)), qd_end.reshape(lead + (nf,)), log


def reset_launch_counts():
    fused_rollout.launches = 0


def launch_counts() -> dict:
    return {"fused_rollout": fused_rollout.launches}


reset_launch_counts()
graphs.COUNTED.append(fused_rollout)    # a captured move counts on every replay
