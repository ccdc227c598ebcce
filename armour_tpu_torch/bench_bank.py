"""Time the collision bank-pass kernels of this tree beside another build of
the same C interface, inside one process on one card.

    python -m armour_tpu_torch.bench_bank [--other NAME=SOURCE.cu[,NVCC_FLAG...]]...
                                          [--batch 128 ...] [--obstacles 8 ...]
                                          [--time-steps 128 ...] [--paths auto small stream]
                                          [--seed 0] [--reps 20] [--ptxas DIR] [--sass]

Kernel times differ by about 10 % from one machine to the next, so two
versions are compared only here: the tree's kernel and every ``--other``
(an earlier commit's `collision_bank.cu` unpacked somewhere, or the same
source with a ``-D`` flag) are built, run on the same bank, held against
each other, and timed in turns (tree, others, others reversed, tree).

The banks are the planner's (`problem_set` with every one of O slots live,
built without culling: bf16 normals, f32 offsets), one for each (B, O, T)
of the lists (default B=128, O=8, T=128; the batch-1 plan's is B=1, the
grasp example's B=1 and T=64); the rows are the launches the port makes:
value + Jacobian at S=4, 1, 8 and 12 (a 12-start plan's), values only at S=4,
10 (the verification pool), 16 and 26 (a 12-start plan's pool).  A source
that refuses a row's start count (one from before any S was one launch) is
left out of that row.  One JSON line per row: ``ms`` times one launch
between two events (the host work of the launch included), ``graph_ms`` one
launch of a CUDA graph of 20 (the device alone, as the kept plan programs
launch it); `bound_ms` is bytes moved (each input read once, each output
written once) over 3.35 TB/s, and ``floor_ms`` the graph time of an empty
kernel (the least any launch costs).  ``--paths`` times every build
through each path named: ``auto`` is the launch's own choice, ``small`` and
``stream`` force one (version names ``tree:small``, ``tree:stream``);
``paths`` is the path each version's launch reported, and every version's
outputs are held to the tree's auto path, bit by bit.  Every ``--other``
source has this tree's C interface (the path argument and the reported
path); `kernels.bind` refuses one without it.  With ``--ptxas DIR`` the
``-Xptxas -v`` log of every build is written there.  Each row names the
tree's streaming grid (`kernels.stream_grid`: start groups, groups a block,
the instantiation's start bound, obstacles a thread, blocks).

``--sass`` reads every build's streaming instantiations with bf16 A and f32
offsets (`cuobjdump -sass`): the staged pair loop's instructions per pair
for one thread, by opcode, and the lane instructions per (slot, start,
pair), one JSON line each; every row of the tree then gains ``issue_ms``,
the time the card needs to issue a consumer's loop for the row's (slot,
start, pair) items at 128 lanes a clock on each SM at the card's maximum SM
clock (the producer's refills and the epilogue left out), beside the byte
bound.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
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


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def pair_loop_counts(library) -> dict:
    """The staged pair loop of each streaming instantiation (bf16 A, f32
    offsets) of a built library, from its SASS: the smallest span of a
    backward branch that holds a barrier wait (SYNCS.PHASECHK) and shared
    loads (LDS) and no EXIT (a wait's retry, placed after the kernel's end,
    branches back into the loop).  Inside it, the largest range that a
    forward branch skips around each bulk copy (UBLKCP; five a refill) and
    that holds no shared load is the producer's, issued by one warp of the
    block, and is counted apart.  For each readable name: the pairs one pass
    of the loop takes, one pair's instructions for one thread (a
    consumer's, and the producer's besides) and the consumer's opcodes, and
    the lane instructions per (slot, start, pair): a consumer's pair over
    the thread's obstacles times the instantiation's start bound."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name, labels = {}, None, {}
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernels.kernel_name(m[1])
            funcs[name], labels = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and name:
            labels[m[1]] = None                          # the next instruction's address
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and name:
            addr = int(m[1], 16)
            for k in [k for k, v in labels.items() if v is None]:
                labels[k] = addr
            target = (re.search(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", m[3])
                      if m[2].startswith("BRA") else None)
            funcs[name].append((addr, m[2], target and (target[1] or target[2]), labels))
    rows = {}
    for name, ins in funcs.items():
        m = re.fullmatch(r"bank_pass<bf16,f32,S<=(\d+),(values|value\+jac)(?:,(\d+) groups)?>", name)
        if not m:
            continue
        branches = []                                    # (from, to) of every resolved branch
        for addr, op, target, labs in ins:
            to = None if target is None else (labs.get(target) if target.startswith(".L")
                                              else int(target, 16))
            if to is not None:
                branches.append((addr, to))
        loop = None
        for addr, to in branches:
            if to > addr:
                continue
            ops = [o for a, o, *_ in ins if to <= a <= addr]
            if (any(o.startswith("SYNCS.PHASECHK") for o in ops) and any(o.startswith("LDS") for o in ops)
                    and not any(o.startswith("EXIT") for o in ops)
                    and (loop is None or addr - to < loop[1] - loop[0])):
                loop = (to, addr)
        if loop is None:
            continue
        # for each copy, the largest forward skip around it that holds no shared load
        skips = [(f, t) for f, t in branches if loop[0] <= f < t <= loop[1]
                 and not any(f < a < t and o.startswith("LDS") for a, o, *_ in ins)]
        producer = set()
        for a, o, *_ in ins:
            around = [(f, t) for f, t in skips if f < a < t] if o.startswith("UBLKCP") else []
            if around:
                f, t = max(around, key=lambda ft: ft[1] - ft[0])
                producer.update(x for x, *_ in ins if f < x < t)
        span = [(a, o) for a, o, *_ in ins if loop[0] <= a <= loop[1]]
        pairs = max(1, sum(o.startswith("UBLKCP") for _, o in span) // 5)
        consumer = [o for a, o in span if a not in producer]
        ops = {}
        for o in consumer:
            ops[o] = ops.get(o, 0) + 1
        bound, jac = int(m[1]), m[2] != "values"
        v = kernels.grid_model().grid_obstacles_per_thread(bound, jac, 4, m[3] is not None)
        rows[name] = {"pairs_per_pass": pairs, "per_pair": len(consumer) / pairs,
                      "producer_per_pair": len(producer) / pairs,
                      "obstacles_per_thread": v, "start_bound": bound,
                      "lane_instructions_per_item": len(consumer) / pairs / (v * bound),
                      "opcodes_per_pair": {k: c / pairs for k, c in
                                           sorted(ops.items(), key=lambda kv: -kv[1])}}
    return rows


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
    ap.add_argument("--batch", type=int, nargs="+", default=[128])
    ap.add_argument("--obstacles", type=int, nargs="+", default=[8])
    ap.add_argument("--time-steps", type=int, nargs="+", default=[128])
    ap.add_argument("--paths", nargs="+", default=["auto"], choices=["auto", "small", "stream"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", type=Path, default=None, help="directory for the ptxas logs")
    ap.add_argument("--sass", action="store_true", help="the pair loops' SASS and issue times")
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
    with ThreadPoolExecutor(len(builds)) as pool:     # one nvcc per build, all at once
        infos = list(pool.map(lambda b: kernels.build(verbose=True, source=b[1], extra_flags=b[2]),
                              builds))
    libs, versions = {}, {}       # version name -> (library, path)
    for (name, source, flags), info in zip(builds, infos):
        libs[name] = lib = kernels.bind(info["path"])
        for path in args.paths:
            auto = path == "auto"
            versions[name if auto else f"{name}:{path}"] = (lib, None if auto else path)
        summary = kernels.ptxas_summary(info["log"])
        if args.ptxas:
            args.ptxas.mkdir(parents=True, exist_ok=True)
            (args.ptxas / f"ptxas_{name}.txt").write_text(info["log"])
        print(json.dumps({"build": name, "source": str(source), "flags": flags,
                          "seconds": round(info["seconds"], 2), "kernels": len(summary),
                          "max_registers": max((r["registers"] for r in summary), default=None),
                          "spilling": [r for r in summary if r["spill_stores"] or r["spill_loads"]]}),
              flush=True)
        if args.sass:
            loops = pair_loop_counts(info["path"])
            registers = {r["kernel"]: r["registers"] for r in summary}
            for kernel, row in loops.items():
                print(json.dumps({"sass": name, "kernel": kernel,
                                  "registers": registers.get(kernel), **row}), flush=True)
            if name == "tree":
                args.tree_loops, args.clock_hz = loops, sm_clock_hz()
    if "tree" not in versions:
        versions = {"tree": (libs["tree"], None), **versions}
    floor = graph_ms(lambda: kernels._launch_empty(lib=libs["tree"]))
    print(json.dumps({"row": "empty_kernel", "card": smi, "grid": [1, 32], "graph_ms": floor,
                      "ms": time_ms(lambda: kernels._launch_empty(lib=libs["tree"]), args.reps)}),
          flush=True)

    spec = kinova_gen3_spec()
    n = spec.n_factors
    for B, O, T in itertools.product(args.batch, args.obstacles, args.time_steps):
        cfg = PlannerConfig(num_time_steps=T, max_obstacles=O)
        bench_bank(args, smi, versions, floor, spec, cfg, B, n)
    return 0


def bench_bank(args, smi, versions, floor, spec, cfg, B, n):
    """The rows of one bank: every version of each launch, timed in turns."""
    S, O = cfg.nlp_num_starts, cfg.max_obstacles
    probs = problem_set(cfg, B, n_obs=O, seed=args.seed, device="cuda")
    planner = ArmourPlanner(spec, cfg, dtype=torch.float32, device="cuda")
    prob = planner.build_probs(probs.q0, probs.qd0, probs.qdd0, probs.zonos, probs.masks,
                               cull=False)
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
        ("values_multi[S=1]", kernels._launch_values_multi, (*bank, c4[:, :1].contiguous())),
        (f"values_multi[S={2 * S + 2}]", kernels._launch_values_multi, (*bank, c10)),
        ("value_jac_multi[S=8]", kernels._launch_value_jac_multi, (*bank, c8, dc8)),
        (f"value_jac_multi[S={S_many}]", kernels._launch_value_jac_multi, (*bank, c12, dc12)),
        ("values_multi[S=16]", kernels._launch_values_multi, (*bank, c16)),
        (f"values_multi[S={2 * S_many + 2}]", kernels._launch_values_multi, (*bank, c26)),
    )
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    for row, launch, tensors in rows:
        outs, paths, refused = {}, {}, {}
        for name, (lib, path) in versions.items():
            try:
                *outs[name], paths[name] = launch(*tensors, lib=lib, path=path)
            except RuntimeError as e:     # another source may refuse the row's start count
                refused[name] = str(e)
        torch.cuda.synchronize()
        names = list(outs)
        order = names + names[:0:-1] + ["tree"] if len(names) > 1 else ["tree", "tree"]
        ref = outs["tree"]
        diff, bits = {}, {}
        for name, out in outs.items():
            diff[name] = float((out[0] - ref[0]).abs().max())
            bits[name] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                             for a, b in zip(out, ref))
        moved = sum(t.numel() * t.element_size() for t in (*tensors, *ref))
        Bk, P, _, L, Ok, T = tensors[0].shape
        Sk, jac = tensors[3].shape[1], len(ref) == 2
        grid = kernels.stream_grid(Sk, L, Ok, T, jac, ref[0].element_size())
        issue = {}
        if args.sass:
            groups = grid["instantiated_groups"]
            kernel = (f"bank_pass<bf16,f32,S<={grid['bound']},{'value+jac' if jac else 'values'}"
                      + (f",{groups} groups>" if groups > 1 else ">"))
            per_item = args.tree_loops[kernel]["lane_instructions_per_item"]
            items = Bk * Sk * P * L * Ok * T
            issue = {"issue_kernel": kernel, "lane_instructions_per_item": per_item,
                     "issue_ms": items * per_item / (sms * 128 * args.clock_hz) * 1e3,
                     "sm_clock_hz": args.clock_hz}
        ms, in_graph = {}, {}
        for name in order:
            lib, path = versions[name]
            ms.setdefault(name, []).append(
                time_ms(lambda: launch(*tensors, lib=lib, path=path), args.reps))
            in_graph.setdefault(name, []).append(
                graph_ms(lambda: launch(*tensors, lib=lib, path=path)))
        print(json.dumps({"row": row, "card": smi, "bank": list(hp.A.shape), "bytes": moved,
                          "bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "floor_ms": floor,
                          "auto_path": paths["tree"], "paths": paths, "sms": sms,
                          "tree_stream_grid": grid, **issue,
                          "order": order, "ms": ms, "graph_ms": in_graph,
                          "max_abs_g_diff_to_tree": diff, "bits_equal_to_tree": bits,
                          "refused": refused}),
              flush=True)
        del outs, ref
    del probs, planner, prob, hp, bank, rows
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
