"""Reference-schema export through the port.

    python -m armour_tpu_torch.export_reference_schema [--f32] [--outdir DIR]
    python -m armour_tpu_torch.export_reference_schema --device cpu --n-samples 20

Counterpart of `scripts/export_reference_schema.py`: writes the real-time
planner's five output files in the reference's `.out` layout
(`kinova_planner_realtime/README.md:101-126`, `armour_main.cu:320-397`)
from the port's pipeline, at the `PZ_tests.cu` debug inputs and hard-coded
k slice (`PZ_tests.cu:19-21,198`), plus a containment report in the style
of `debug_script.m`: ground-truth f64 RNEA torques and FK link positions,
sampled inside each time interval with tracking-error and
inertia-uncertainty samples, must lie inside the exported sliced sets.

Files written to --outdir:
  armour_main.out                        the fixed k, then the build time in ms
  armour_main_joint_position_center.out  T*L lines of 3: sliced link centres
  armour_main_joint_position_radius.out  T*L*3 lines of 6: link generator matrix
  armour_main_control_input_radius.out   T lines of NUM_FACTORS
  armour_main_constraints.out            torque centres (T*nf), then the
                                         pos/vel bounds as lb+qe / ub-qe
  containment_report.json                sampled ground-truth containment

The samples are drawn from ``numpy.random.default_rng(0)`` in the script's
order (per interval: the times, then per time the tracking errors and the
mass scales), then pushed through one batched RNEA and FK pass.  Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.device import resolve_device, to_numpy
from armour_tpu_torch.dynamics.pz_rnea import build_reachable_sets
from armour_tpu_torch.dynamics.rnea import forward_kinematics, link_constants, rnea
from armour_tpu_torch.jrs.bezier import bezier_ref, make_bezier_jrs
from armour_tpu_torch.ops.pz import pack_pzs
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

PZ_TESTS_K = [0.5, 0.6, 0.7, 0.0, -0.5, -0.6, -0.7]
PZ_TESTS_Q0 = [0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0]
OUT_FILES = ("armour_main.out", "armour_main_joint_position_center.out",
             "armour_main_joint_position_radius.out", "armour_main_control_input_radius.out",
             "armour_main_constraints.out")


def sliced_sets(spec, cfg: PlannerConfig, dtype, device):
    """The pipeline at the `PZ_tests.cu` inputs, sliced at ``PZ_TESTS_K``:
    (link centres (T, L, 3), link generators (T, L, 3, 6), torque radius
    (T, nf), torque centres (T, nf)) as f64 numpy arrays, and the build
    time in ms (JRS to slice, ended by a device synchronise)."""
    nf = spec.n_factors
    q0 = torch.as_tensor([PZ_TESTS_Q0], dtype=dtype, device=device)
    zero = torch.zeros((1, nf), dtype=dtype, device=device)
    k = torch.as_tensor(PZ_TESTS_K, dtype=dtype, device=device)[None, None]   # (B=1, S=1, n)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    jrs = make_bezier_jrs(spec, cfg, q0, zero, zero)
    rs = build_reachable_sets(spec, cfg, jrs)
    link_c, _, _ = pack_pzs(rs.link_pz, axis=2).slice_with_jac_multi(k)   # (1, 1, T, L, 3)
    u_c, _, _ = pack_pzs(rs.u_nom, axis=-1).slice_with_jac_multi(k)       # (1, 1, T, nf)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3

    def host(x):
        return to_numpy(x).astype(np.float64)

    return (host(link_c[0, 0]), host(rs.link_indep_gens[0]), host(rs.torque_radius[0]),
            host(u_c[0, 0]), ms)


def write_out_files(outdir, spec, k, ms, link_c, gens, t_rad, u_c):
    """The five `.out` files (`armour_main.cu:320-397`): ``%.10g`` with
    ``" \\n"`` line ends, ``%.6g`` in the constraints file."""
    T, L = link_c.shape[:2]
    nf = spec.n_factors
    os.makedirs(outdir, exist_ok=True)

    def w(name, text):
        with open(os.path.join(outdir, name), "w") as f:
            f.write(text)

    w(OUT_FILES[0], "".join(f"{v:.10g}\n" for v in k) + f"{ms:.10g}")
    w(OUT_FILES[1], "".join(" ".join(f"{v:.10g}" for v in link_c[i, j]) + " \n"
                            for i in range(T) for j in range(L)))
    w(OUT_FILES[2], "".join(" ".join(f"{v:.10g}" for v in gens[i, j, r]) + " \n"
                            for i in range(T) for j in range(L) for r in range(3)))
    w(OUT_FILES[3], "".join(" ".join(f"{v:.10g}" for v in t_rad[i]) + " \n" for i in range(T)))
    # the first T*nf entries are the torque PZ centres (README.md: "the first
    # NUM TIME STEPS - NUM FACTORS entries are just the center of the control
    # input PZ"), then the pos/vel bounds with the qe/qde padding
    lines = [f"{u_c[i, j]:.6g}\n" for i in range(T) for j in range(nf)]
    for i in range(nf):
        lines += [f"{spec.pos_limits_lb[i] + spec.qe:.6g}\n",
                  f"{spec.pos_limits_ub[i] - spec.qe:.6g}\n"]
    for i in range(nf):
        lines += [f"{-spec.speed_limits[i] + spec.qde:.6g}\n",
                  f"{spec.speed_limits[i] - spec.qde:.6g}\n"]
    w(OUT_FILES[4], "".join(lines))


def draw_samples(spec, cfg: PlannerConfig, n_samples: int, seed: int = 0):
    """Ground-truth sample draws in the JAX script's order: per interval i,
    ``n_samples`` times in it; per time, the position and velocity tracking
    errors and the per-link mass scales.  Returns (interval (N,), t (N,),
    eq (N, nf), eqd (N, nf), mass scale (N, L)), N = T * n_samples."""
    rng = np.random.default_rng(seed)
    T, nf, L = cfg.num_time_steps, spec.n_factors, spec.n_joints
    dt = cfg.duration / T
    ts, eqs, eqds, scales = [], [], [], []
    for i in range(T):
        for t in rng.uniform(i * dt, (i + 1) * dt, n_samples):
            ts.append(t)
            eqs.append(rng.uniform(-spec.qe, spec.qe, nf))
            eqds.append(rng.uniform(-spec.qde, spec.qde, nf))
            scales.append(rng.uniform(1 - spec.mass_uncertainty, 1 + spec.mass_uncertainty, L))
    return (np.repeat(np.arange(T), n_samples), np.asarray(ts), np.stack(eqs), np.stack(eqds),
            np.stack(scales))


def containment(spec, cfg: PlannerConfig, link_c, gens, t_rad, u_c, n_samples: int, device):
    """Counts and minimum margins of the sampled ground truth inside the
    sliced sets: one batched f64 pass of `bezier_ref`, RNEA (per-sample
    inertias) and FK over all T * n_samples samples."""
    f64 = torch.float64

    def t(x):
        return torch.as_tensor(x, dtype=f64, device=device)

    idx, ts, eq, eqd, scale = draw_samples(spec, cfg, n_samples)
    zero = t(np.zeros(spec.n_factors))
    k_act = t(np.asarray(PZ_TESTS_K) * cfg.k_range)
    qref, qdref, qddref = bezier_ref(t(PZ_TESTS_Q0), zero, zero, k_act, t(ts)[:, None],
                                     cfg.duration)
    eq, eqd, scale = t(eq), t(eqd), t(scale)
    q_s, qd_s = qref + eq, qdref + eqd
    consts = link_constants(spec, q_s, mass=t(spec.mass) * scale,
                            inertia=t(spec.inertia) * scale[..., None, None])
    tau = rnea(spec, q_s, qd_s, qdref + spec.kr * eq, qddref + spec.kr * eqd,
               use_gravity=True, use_armature=True, consts=consts)
    Rw, pw = forward_kinematics(spec, q_s)
    ctr = torch.einsum("nlij,lj->nli", Rw, t(spec.link_zono_center)) + pw     # (N, L, 3)

    tau, ctr = to_numpy(tau), to_numpy(ctr)
    tor_dev = np.abs(tau - u_c[idx])
    tor_margin = (t_rad[idx] - tor_dev).min(axis=1)
    half = np.abs(gens).sum(axis=-1)[idx]                                      # (N, L, 3)
    pos_dev = np.abs(ctr - link_c[idx])
    pos_margin = (half - pos_dev).min(axis=(1, 2))
    return {
        "torque_containment_violations": int((tor_dev > t_rad[idx]).any(axis=1).sum()),
        "torque_min_margin_Nm": float(tor_margin.min()),
        "link_center_containment_violations": int((pos_dev > half).any(axis=(1, 2)).sum()),
        "link_min_margin_m": float(pos_margin.min()),
    }


def export(outdir, time_steps: int = 128, n_samples: int = 40, dtype=torch.float64,
           device=None) -> dict:
    """Write the five `.out` files and ``containment_report.json`` to
    ``outdir`` from the ``dtype`` pipeline on ``device``; returns the
    report.  The ground truth is f64 in either pipeline."""
    device = resolve_device(device)
    spec = kinova_gen3_spec()
    cfg = PlannerConfig(num_time_steps=time_steps)
    link_c, gens, t_rad, u_c, ms = sliced_sets(spec, cfg, dtype, device)
    write_out_files(outdir, spec, PZ_TESTS_K, ms, link_c, gens, t_rad, u_c)
    report = {
        "pipeline_dtype": str(dtype).removeprefix("torch."),
        "time_steps": time_steps,
        "k_slice": PZ_TESTS_K,
        "samples_per_interval": n_samples,
        **containment(spec, cfg, link_c, gens, t_rad, u_c, n_samples, device),
        "build_ms": round(ms, 1),
    }
    with open(os.path.join(outdir, "containment_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                   "armour_tpu_torch_reference_schema"))
    ap.add_argument("--time-steps", type=int, default=128)
    ap.add_argument("--n-samples", type=int, default=40,
                    help="ground-truth samples per time interval")
    ap.add_argument("--f32", action="store_true",
                    help="export the f32 production pipeline instead of f64")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    report = export(args.outdir, args.time_steps, args.n_samples,
                    torch.float32 if args.f32 else torch.float64, args.device)
    print(json.dumps(report, indent=2))
    if report["torque_containment_violations"] or report["link_center_containment_violations"]:
        raise SystemExit("containment violated!")
    print(f"wrote reference-schema artifacts to {args.outdir}")


if __name__ == "__main__":
    main()
