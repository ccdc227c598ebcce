"""Two battery records held world by world.

    python -m armour_tpu_torch.battery_table A.json B.json [--half armour]

Each world's outcome in a record (``run_worlds`` JSON, or one half of a
``run_armtd_comparison`` JSON with ``--half``) is ``goal`` (reached),
``stop`` (stopped safely, no goal) or ``open`` (neither, at the iteration
cap or where the run was cut).  Prints one JSON line: the 3 x 3 table of A's
outcome against B's over the worlds both ran, the worlds off its diagonal,
and each record's safety counts (collisions, torque, joint-limit and
ultimate-bound violations).
"""

from __future__ import annotations

import argparse
import json

OUTCOMES = ("goal", "stop", "open")
SAFETY = ("collision", "torque_violation", "joint_limit_violation", "ultimate_bound_violation")


def outcome(row: dict) -> str:
    return "goal" if row["goal_reached"] else ("stop" if row["stopped"] else "open")


def versus(a: dict, b: dict) -> dict:
    """A's outcomes (rows) against B's (columns) over their common worlds."""
    oa = {r["world"]: outcome(r) for r in a["worlds"]}
    ob = {r["world"]: outcome(r) for r in b["worlds"]}
    common = sorted(set(oa) & set(ob))
    table = {x: {y: 0 for y in OUTCOMES} for x in OUTCOMES}
    off = {}
    for w in common:
        table[oa[w]][ob[w]] += 1
        if oa[w] != ob[w]:
            off.setdefault(f"{oa[w]}/{ob[w]}", []).append(w)
    return {"worlds": len(common), "table": table, "off_diagonal": off,
            "safety": [{k: sum(bool(r[k]) for r in d["worlds"] if r["world"] in common)
                        for k in SAFETY} for d in (a, b)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--half", nargs=2, default=(None, None), metavar=("HALF_A", "HALF_B"),
                    help="the comparison half of each file (or - for a plain record)")
    args = ap.parse_args(argv)
    recs = []
    for path, half in zip((args.a, args.b), args.half):
        with open(path) as f:
            d = json.load(f)
        recs.append(d[half] if half not in (None, "-") else d)
    out = versus(*recs)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
