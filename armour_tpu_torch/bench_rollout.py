"""Time the rollout kernel of this tree beside another build of it, inside
one process on one card, and read what the compiler made of it.

    python -m armour_tpu_torch.bench_rollout [--other NAME=SOURCE.cu]...
        [--run-time] [--batch 128 100] [--dtype float32 float64] [--steps 1000]
        [--reps 10] [--probe] [--sass] [--ptxas DIR]

The move is the battery's: the Kinova, the robust controller, the Bezier
reference, measurement noise 1e-4, random plans from ``--seed``.  Every
version (the tree's `csrc/rollout.cu` and each ``--other``, an earlier
commit's source unpacked somewhere) is built with ``-Xptxas -v``, run on the
same packed inputs, held against the tree's end state, and timed with CUDA
events in turns (tree, others, others reversed, tree; the median of
``--reps`` launches each).  ``--run-time`` adds the tree's source with the
Kinova's launch taken out, so that the move runs through the instantiation
with a run-time joint count (version ``run-time``): what the Kinova's own
instantiation gains.

``--sass`` counts each instantiation's SASS instructions by opcode
(`cuobjdump -sass`).  ``--probe`` builds a copy of the tree's source with
``clock64()`` probes inserted after fixed statements (the committed source
has none) and reports, for block 0, each warp's cycles per step by stage:
warp 0 (the state, the rotations, the solves), warp 1 (the bias rows),
warps 2-3 (the mass matrix and its factorisation), warp 4 (the
controller's nominal pass, the reference) and warps 5-7 (the other
controller passes).  A stage's cycles run from the
previous probe of the same warp to its own, so waits show as stages too.

One JSON line per reading; the card's name and power limit with each.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .bench_bank import nvidia_smi, sm_clock_hz, time_ms
from .collision import kernels
from .config import PlannerConfig, SimConfig
from .robots.kinova import kinova_gen3_spec
from .sim import rollout_kernel as rk
from .sim.agent import CONTROLLERS, TrajParams, TrueParams

# the probes: (stage, warp, the statement the probe follows, with the context
# that makes it unique as a lookahead); each must match exactly once
PROBES = (
    ("w0 step start: the inputs that need the rates, step barrier", 0,
     r"bar_sync<BAR_STEP, CTRL_THREADS>\(\);(?=\n\n      // ---- RK4)"),
    ("w0 next position's rotations (x3)", 0, r"bar_arrive_slot<BAR_POS>\(s \^ 1\);"),
    ("w0 next step's position, reference and point", 0, r"prepare\(i \+ 1, q_next\);"),
    ("w0 wait for the controller and the first bias row", 0,
     r"bar_sync<BAR_CTRL, CTRL_THREADS>\(\);"),
    ("w0 control law", 0, r"          \}\n          __syncwarp\(\);"),
    ("w0 wait for a bias row (x3)", 0, r"bar_sync<BAR_BIAS, 64>\(\);"),
    ("w0 wait for a factorisation (x4)", 0, r"bar_sync_slot<BAR_FACT>\(s\);"),
    ("w0 solve (x4)", 0, r"kv = solved\(s\);"),
    ("w0 sums and the next rates (x4)", 0, r"bar_arrive<BAR_RATES, 64>\(\);\n        \}"),
    ("w1 wait for the step", 1, r"bar_sync<BAR_STEP, CTRL_THREADS>\(\);(?=\n#pragma unroll 1)"),
    ("w1 wait for the rates (x3)", 1, r"if \(k > 0\) bar_sync<BAR_RATES, 64>\(\);"),
    ("w1 bias row (x4)", 1, r"true_inertia, fn, wk\.bias\);"),
    ("w2-3 wait for a position (x4, both warps)", 2, r"bar_sync_slot<BAR_POS>\(s\);"),
    ("w2-3 mass-matrix columns (x4, both warps)", 2, r"fn, wk\.col\[m\] \+ lane \* CS\);"),
    ("w2-3 transpose and factorisation (x4, both warps)", 2,
     r"factor<S, N>\(sm, wk\.col\[m\], nf, lane, s\);"),
    ("w4 wait for the step", 4,
     r"bar_sync<BAR_STEP, CTRL_THREADS>\(\);(?=\n      if \(lane == 0\)\n        rnea)"),
    ("w4 nominal pass", 4, r"nom_mass, nom_inertia, fn, wk\.tau\);"),
    ("w4 next reference", 4, r"if \(i \+ 1 < n_steps\) next_reference\(i \+ 1\);"),
    ("w5-7 wait for the step (three warps)", 5,
     r"bar_sync<BAR_STEP, CTRL_THREADS>\(\);(?=\n      if \(lane == 0 && run\))"),
    ("w5-7 M r and absolute passes (three warps)", 5, r"wk\.mrd\);\n      \}"),
)

_PROBE_HEAD = r"""
__device__ unsigned long long armour_probe[64];
#define ARMOUR_PROBE(id)                                                              \
  do {                                                                                \
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) {                                 \
      const long long now = clock64();                                                \
      atomicAdd(&armour_probe[id], (unsigned long long)(now - armour_last));          \
      armour_last = now;                                                              \
    }                                                                                 \
  } while (0)
"""

_PROBE_READ = r"""
extern "C" int armour_rollout_probe(unsigned long long* out, int reset) {
  if (reset) {
    static const unsigned long long zero[64] = {0};
    return (int)cudaMemcpyToSymbol(armour_probe, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, armour_probe, sizeof(armour_probe));
}
"""


def probed_source(src: str) -> str:
    """The source with a clock64() probe after each statement of PROBES."""
    for k, (stage, _, pattern) in enumerate(PROBES):
        hits = list(re.finditer(pattern, src))
        if len(hits) != 1:
            raise ValueError(f"probe {stage!r}: {len(hits)} matches of {pattern!r}")
        end = hits[0].end()
        src = src[:end] + f" ARMOUR_PROBE({k});" + src[end:]
    head = src.index("namespace {")
    src = src[:head] + _PROBE_HEAD + src[head:]
    split = src.index("  if (warp == 0) {")
    src = src[:split] + "  long long armour_last = clock64();\n" + src[split:]
    return src + _PROBE_READ


# the Kinova's launch, taken out of the source by ``--run-time``
_KINOVA_LAUNCH = r"\n    case 7: rollout_kernel<S, 7><<<[^\n]*"


def run_time_source(src: str) -> str:
    """The source with the Kinova's launch taken out: every chain then
    runs through the instantiation with a run-time joint count."""
    out, n = re.subn(_KINOVA_LAUNCH, "", src)
    if n != 1:
        raise ValueError(f"{n} matches of the Kinova's launch {_KINOVA_LAUNCH!r}")
    return out


class Version:
    """A built rollout library (the tree's buffer layout, checked by ``rk.bind``)."""

    def __init__(self, name: str, source: Path):
        self.name, self.source = name, Path(source)
        info = kernels.build(verbose=True, source=self.source)
        self.path, self.log = info["path"], info["log"]
        self.ptxas = kernels.ptxas_summary(info["log"])
        self.build_s = info["seconds"]
        self.lib = rk.bind(self.path)

    def launcher(self, spec, sim, packed, noise, q_end, qd_end, logs, controller="robust"):
        n_steps = int(round(sim.t_move / sim.plant_dt))
        log_every = max(1, int(round(sim.check_dt / sim.plant_dt)))
        B = packed.world.shape[0]
        args = (rk._DTYPE_CODE[packed.world.dtype], CONTROLLERS.index(controller),
                packed.spec.data_ptr(), packed.ispec.data_ptr(), packed.world.data_ptr(),
                noise.data_ptr(), None, B, spec.n_joints, spec.n_factors, n_steps, log_every, 0,
                sim.plant_dt, sim.plant_dt / sim.check_dt, 1.0, sim.t_move, 0, q_end.data_ptr(),
                qd_end.data_ptr(), *(logs[j].data_ptr() for j in range(5)),
                torch.cuda.current_stream().cuda_stream)

        def run():
            err = self.lib.armour_rollout(*args)
            if err:
                raise RuntimeError(f"{self.name}: armour_rollout returned {err}")
        return run


def _variant(name: str, src: str) -> Path:
    """``src`` written where the build keeps its variants."""
    path = kernels.BUILD_DIR / "variants" / name / "rollout.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def move_inputs(B: int, steps: int, dtype, seed: int):
    """The battery's move at B worlds: random plans near their start."""
    spec, cfg = kinova_gen3_spec(), PlannerConfig()
    rng = np.random.default_rng(seed)
    nf = spec.n_factors
    q0, qd0 = rng.uniform(-1, 1, (B, nf)), rng.uniform(-0.3, 0.3, (B, nf))
    on = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")  # noqa: E731
    traj = TrajParams(on(q0), on(qd0), on(rng.uniform(-0.5, 0.5, (B, nf))),
                      on(rng.uniform(-1, 1, (B, nf)) * cfg.k_range), on(rng.uniform(0.0, 0.5, B)))
    scale = on(rng.uniform(*SimConfig().uncertain_mass_range, (B, spec.n_joints)))
    sim = dataclasses.replace(SimConfig(), t_move=steps * SimConfig().plant_dt)
    noise = on(rng.normal(scale=1e-4, size=(steps, 2, B, nf)))
    packed = rk.pack(spec, on(q0), on(qd0), traj, TrueParams(scale, scale))
    return spec, sim, packed, rk.pack_noise(noise, packed.lead, nf)


def sass_counts(path: str) -> dict:
    """Instructions by opcode of each kernel function in a built library."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m[1]
            k = re.search(r"rollout_kernelI(f|d)Li(\d+)E", name)
            if k:
                name = f"rollout_kernel<{ {'f': 'f32', 'd': 'f64'}[k[1]]},{k[2]}>"
            funcs[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            op = m[1].split(".")[0]
            funcs[name][op] = funcs[name].get(op, 0) + 1
    return {f: {"total": sum(c.values()), **dict(sorted(c.items(), key=lambda kv: -kv[1]))}
            for f, c in funcs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=SOURCE.cu")
    ap.add_argument("--run-time", action="store_true",
                    help="also the Kinova through the run-time instantiation")
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 100])
    ap.add_argument("--dtype", nargs="+", default=["float32", "float64"])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--probe", nargs="*", default=None, metavar="NAME",
                    help="per-stage cycles of these versions (no name: the tree's)")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--ptxas", type=Path, default=None,
                    help="write each build's -Xptxas -v log here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_rollout: no CUDA device is available", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    versions = [Version("tree", rk.SOURCE)]
    if args.run_time:
        versions.append(Version("run-time", _variant("run-time", run_time_source(
            rk.SOURCE.read_text()))))
    for item in args.other:
        name, _, src = item.partition("=")
        versions.append(Version(name, Path(src)))
    for v in versions:
        print(json.dumps({"version": v.name, "source": str(v.source), "build_s": v.build_s,
                          "ptxas": v.ptxas, "nvidia_smi": smi}), flush=True)
        if args.ptxas:
            args.ptxas.mkdir(parents=True, exist_ok=True)
            (args.ptxas / f"rollout_{v.name}_ptxas.txt").write_text(v.log)
        if args.sass:
            print(json.dumps({"version": v.name, "sass": sass_counts(v.path)}), flush=True)

    order = versions + versions[::-1]
    for dname in args.dtype:
        dtype = getattr(torch, dname)
        for B in args.batch:
            spec, sim, packed, noise = move_inputs(B, args.steps, dtype, args.seed)
            n_log = len(range(0, args.steps, max(1, int(round(sim.check_dt / sim.plant_dt)))))
            outs, runs = {}, {}
            for v in versions:
                q_end = torch.empty((B, spec.n_factors), dtype=dtype, device="cuda")
                qd_end = torch.empty_like(q_end)
                logs = torch.empty((5, B, n_log, spec.n_factors), dtype=dtype, device="cuda")
                runs[v.name] = v.launcher(spec, sim, packed, noise, q_end, qd_end, logs)
                runs[v.name]()
                torch.cuda.synchronize()
                outs[v.name] = (q_end, qd_end, logs)
            ref = outs["tree"]
            times = {v.name: [] for v in versions}
            for v in order:
                times[v.name].append(time_ms(runs[v.name], args.reps))
            for v in versions:
                got = outs[v.name]
                err = {"q_end": float((got[0] - ref[0]).abs().max()),
                       "qd_end": float((got[1] - ref[1]).abs().max()),
                       "u_log": float((got[2][4] - ref[2][4]).abs().max())}
                print(json.dumps({"version": v.name, "dtype": dname, "worlds": B,
                                  "steps": args.steps, "ms_per_move": times[v.name],
                                  "us_per_step": statistics.median(times[v.name]) * 1e3
                                  / args.steps,
                                  "max_abs_diff_to_tree": err, "nvidia_smi": smi}), flush=True)

    sources = {v.name: v.source for v in versions}
    for name in ([] if args.probe is None else args.probe or ["tree"]):
        v = Version(f"probe:{name}", _variant(f"probe/{name}",
                                              probed_source(sources[name].read_text())))
        v.lib.armour_rollout_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        clock = sm_clock_hz()
        for dname in args.dtype:
            dtype = getattr(torch, dname)
            B = args.batch[0]
            spec, sim, packed, noise = move_inputs(B, args.steps, dtype, args.seed)
            n_log = len(range(0, args.steps, max(1, int(round(sim.check_dt / sim.plant_dt)))))
            q_end = torch.empty((B, spec.n_factors), dtype=dtype, device="cuda")
            logs = torch.empty((5, B, n_log, spec.n_factors), dtype=dtype, device="cuda")
            run = v.launcher(spec, sim, packed, noise, q_end, torch.empty_like(q_end), logs)
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 64)()
            v.lib.armour_rollout_probe(None, 1)
            ms = time_ms(run, 1, warmup=0)
            v.lib.armour_rollout_probe(ctypes.cast(buf, ctypes.c_void_p), 0)
            per_warp = {}
            stages = []
            for k, (stage, warp, _) in enumerate(PROBES):
                cyc = buf[k] / args.steps
                per_warp[warp] = per_warp.get(warp, 0.0) + cyc
                stages.append({"stage": stage, "cycles_per_step": cyc})
            print(json.dumps({"probe": v.name, "dtype": dname, "worlds": B, "steps": args.steps,
                              "ms_per_move": ms,
                              "sm_clock_max_hz": clock, "stages": stages,
                              "cycles_per_step_by_warp": per_warp,
                              "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
