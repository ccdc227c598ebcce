"""ARMOUR against ARMTD on one world suite (`scripts/run_armtd_comparison.py`)
through the port.

    python -m armour_tpu_torch.run_armtd_comparison [--max-iterations 500]
        [--out results/torch_armtd_vs_armour.json]
    python -m armour_tpu_torch.run_armtd_comparison --device cpu --max-worlds 2 \\
        --max-iterations 2 --time-steps 16 --f64 --collision-oracle box

Runs the battery of ``run_worlds`` twice over the same worlds with the same
seed: once with the ARMOUR planner (``--traj-type bernstein``: Bezier
trajectories, torque and tracking-error-aware constraints) and once with
original ARMTD (``--traj-type orig``: constant-acceleration trajectories,
collision and state limits only).  Writes ``{"armour": ..., "armtd": ...}``,
each half in ``run_worlds``'s JSON schema, and prints one summary line per
half.  The paper's claim is equal safety (no collision in either half) and
fewer goals or torque violations for ARMTD, which constrains no input.

``--halves`` runs a subset (a half can take most of an hour on a card) and
merges it into the halves an existing ``--out`` already holds.  Halves and
disjoint ``--worlds`` subsets run side by side, each with its own ``--out``,
are joined world by world with ``python -m armour_tpu_torch.run_worlds
--join A.json B.json ... --out all.json``.  With ``--progress-every N`` each
half also writes its partial record every N iterations to
``<out>.<half>.progress.json``.  Flags that
this script does not know (``--time-steps``, ``--f64``,
``--collision-oracle``, ``--batch``, ...) go to both ``run_worlds`` runs.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from armour_tpu_torch import run_worlds

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HALVES = {"armour": "bernstein", "armtd": "orig"}
DEFAULT_OUT = os.path.join(ROOT, "results", "torch_armtd_vs_armour.json")


def main(argv=None) -> dict:
    # no abbreviations: run_worlds' --worlds must pass through, not match --worlds-dir
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--worlds-dir", default=run_worlds.ASSETS)
    ap.add_argument("--max-worlds", type=int, default=100)
    ap.add_argument("--max-iterations", type=int, default=500)
    ap.add_argument("--hlp", default="straight")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--halves", nargs="+", default=list(HALVES), choices=list(HALVES))
    args, rest = ap.parse_known_args(argv)

    results = {}
    if set(args.halves) != set(HALVES) and os.path.exists(args.out):
        with open(args.out) as f:
            results = {k: v for k, v in json.load(f).items() if k in HALVES}
    common = ["--worlds-dir", args.worlds_dir, "--max-worlds", str(args.max_worlds),
              "--max-iterations", str(args.max_iterations), "--hlp", args.hlp, *rest]
    if args.device is not None:
        common += ["--device", args.device]
    for name in args.halves:
        print(f"=== {name} ({HALVES[name]}) ===", flush=True)
        # with --progress-every, each half keeps its partial record beside --out
        progress = (["--out", f"{os.path.splitext(args.out)[0]}.{name}.progress.json"]
                    if "--progress-every" in rest else [])
        results[name] = run_worlds.main([*common, "--traj-type", HALVES[name], *progress])
    results = {k: results[k] for k in HALVES if k in results}

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    for name, r in results.items():
        print(f"{name:>7}: success {r['success']}/{r['n_worlds']}, "
              f"collisions {r['collision']}, torque {r['torque_violation']}, "
              f"stops {r['stopped_safely']}")
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
