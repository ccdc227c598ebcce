"""Time the collision bank-pass kernels of this tree beside another build of
the same C interface, inside one process on one card.

    python -m armour_tpu_torch.bench_bank [--other NAME=SOURCE.cu[,NVCC_FLAG...]]...
                                          [--obstacles 8] [--seed 0] [--reps 20]

Kernel times differ by about 10 % from one machine to the next, so two
versions are compared only here: the tree's kernel and every ``--other``
(an earlier commit's `collision_bank.cu` unpacked somewhere, or the same
source with a ``-D`` flag) are built, run on the same bank, held against
each other, and timed in turns (tree, others, others reversed, tree).

The bank is the one the planner's main path builds (`problem_set`, B=128,
T=128, bf16 normals, f32 offsets); the rows are the launches the port makes:
value + Jacobian at S=4, 1, 8 and 12 (a 12-start plan's), values only at S=4,
10 (the verification pool), 16 and 26 (a 12-start plan's pool).  A source
that refuses a row's start count (one from before any S was one launch) is
left out of that row.  One JSON line per row: ``ms`` times one launch
between two events (the host work of the launch included), ``graph_ms`` one
launch of a CUDA graph of 20 (the device alone, as the kept plan programs
launch it); `bound_ms` is bytes moved (each input read once, each output
written once) over 3.35 TB/s.  With ``--ptxas DIR`` the ``-Xptxas -v`` log
of every build is written there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .collision import kernels
from .collision.zonotope import kernel_layout
from .config import PlannerConfig
from .planner.armour import ArmourPlanner
from .problems import problem_set
from .robots.kinova import kinova_gen3_spec

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM5, NVIDIA's data sheet


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured into one CUDA graph,
    whose replay is timed with CUDA events after a warm-up replay, divided by
    ``calls``; the median of ``reps`` replays.  No host work falls between the
    launches, as in a kept program's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()                  # the graph's private pool goes with it
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=SOURCE[,FLAG...]")
    ap.add_argument("--obstacles", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", type=Path, default=None, help="directory for the ptxas logs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_bank: no CUDA device is available", file=sys.stderr)
        return 1
    smi = nvidia_smi()

    builds = [("tree", kernels.SOURCE, ())]
    for item in args.other:
        name, _, rest = item.partition("=")
        source, *flags = rest.split(",")
        builds.append((name, Path(source), tuple(flags)))
    libs = {}
    for name, source, flags in builds:
        info = kernels.build(verbose=True, source=source, extra_flags=flags)
        libs[name] = kernels.bind(info["path"])
        summary = kernels.ptxas_summary(info["log"])
        if args.ptxas:
            args.ptxas.mkdir(parents=True, exist_ok=True)
            (args.ptxas / f"ptxas_{name}.txt").write_text(info["log"])
        print(json.dumps({"build": name, "source": str(source), "flags": flags,
                          "seconds": round(info["seconds"], 2), "kernels": len(summary),
                          "max_registers": max((r["registers"] for r in summary), default=None),
                          "spilling": [r for r in summary if r["spill_stores"] or r["spill_loads"]]}),
              flush=True)

    spec, cfg = kinova_gen3_spec(), PlannerConfig()
    B, S, n = args.batch, cfg.nlp_num_starts, spec.n_factors
    probs = problem_set(cfg, B, n_obs=args.obstacles, seed=args.seed, device="cuda")
    planner = ArmourPlanner(spec, cfg, dtype=torch.float32, device="cuda")
    prob = planner.build_probs(probs.q0, probs.qd0, probs.qdd0, probs.zonos, probs.masks)
    hp = prob.hp
    rng = np.random.default_rng(1)

    def starts(count):
        K = torch.as_tensor(rng.uniform(-0.9, 0.9, (B, count, n)), dtype=torch.float32, device="cuda")
        centers, _, dcenters = prob.links.slice_with_jac_multi(K)
        return kernel_layout(centers, dcenters)

    c4, dc4 = starts(S)
    c10, _ = starts(2 * S + 2)
    S_many = 12
    c8, dc8 = starts(8)
    c12, dc12 = starts(S_many)
    c16, _ = starts(16)
    c26, _ = starts(2 * S_many + 2)
    bank = (hp.A, hp.dpos, hp.dneg)
    rows = (
        ("value_jac_multi[S=4]", kernels._launch_value_jac_multi, (*bank, c4, dc4)),
        ("values_multi[S=4]", kernels._launch_values_multi, (*bank, c4)),
        ("value_jac[S=1]", kernels._launch_value_jac_multi,
         (*bank, c4[:, :1].contiguous(), dc4[:, :1].contiguous())),
        (f"values_multi[S={2 * S + 2}]", kernels._launch_values_multi, (*bank, c10)),
        ("value_jac_multi[S=8]", kernels._launch_value_jac_multi, (*bank, c8, dc8)),
        (f"value_jac_multi[S={S_many}]", kernels._launch_value_jac_multi, (*bank, c12, dc12)),
        ("values_multi[S=16]", kernels._launch_values_multi, (*bank, c16)),
        (f"values_multi[S={2 * S_many + 2}]", kernels._launch_values_multi, (*bank, c26)),
    )
    for row, launch, tensors in rows:
        outs, refused = {}, {}
        for name, lib in libs.items():
            try:
                outs[name] = launch(*tensors, lib=lib)
            except RuntimeError as e:     # an earlier source may refuse the row's start count
                refused[name] = str(e)
        torch.cuda.synchronize()
        names = list(outs)
        order = names + names[:0:-1] + ["tree"] if len(names) > 1 else ["tree", "tree"]
        ref = outs["tree"]
        ref = ref if isinstance(ref, tuple) else (ref,)
        diff = {}
        for name, out in outs.items():
            out = out if isinstance(out, tuple) else (out,)
            # values must agree to rounding; Jacobians may pick another normal at a tie
            diff[name] = float((out[0] - ref[0]).abs().max())
        moved = sum(t.numel() * t.element_size() for t in (*tensors, *ref))
        ms, in_graph = {}, {}
        for name in order:
            ms.setdefault(name, []).append(
                time_ms(lambda: launch(*tensors, lib=libs[name]), args.reps))
            in_graph.setdefault(name, []).append(graph_ms(lambda: launch(*tensors, lib=libs[name])))
        print(json.dumps({"row": row, "card": smi, "bank": list(hp.A.shape), "bytes": moved,
                          "bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "order": order,
                          "ms": ms, "graph_ms": in_graph, "max_abs_g_diff_to_tree": diff,
                          "refused": refused}),
              flush=True)
        del outs, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
