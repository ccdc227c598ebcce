"""The port's ARMOUR-against-ARMTD comparison
(``python -m armour_tpu_torch.run_armtd_comparison``, the counterpart of
`scripts/run_armtd_comparison.py`), on the CPU at a small size: 2 worlds of
`assets/worlds`, T=16, 1 iteration, the box oracle.  Each half is the
battery ``run_worlds`` called with the standalone command's flags, the
ARMTD half (the second, run after the ARMOUR half in one process) equals
``run_worlds`` run alone on the same worlds and seed, and each half has the
keys of the JAX package's `results/r4_armtd_vs_armour.json` plus the
port's ``device`` and ``protocol``.  No JAX here.
"""

import json
import os

import pytest
import torch

from armour_tpu_torch import run_armtd_comparison, run_worlds

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_FILE = os.path.join(ROOT, "results", "r4_armtd_vs_armour.json")
SMALL = ["--device", "cpu", "--max-worlds", "2", "--max-iterations", "1", "--time-steps", "16",
         "--collision-oracle", "box"]
TIMED = ("wall_seconds", "episodes_per_minute")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Two worlds: one intra-op thread runs them as fast as eight, and
    leaves the cores to the other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _untimed(d):
    return {k: v for k, v in d.items() if k not in TIMED}


def _flags(argv):
    """``argv`` as {flag: value} (a flag with no value maps to None)."""
    out, i = {}, 0
    while i < len(argv):
        has_value = i + 1 < len(argv) and not argv[i + 1].startswith("--")
        out[argv[i]] = argv[i + 1] if has_value else None
        i += 2 if has_value else 1
    return out


def test_comparison_halves_equal_run_worlds_alone(tmp_path, monkeypatch):
    calls = []
    real_main = run_worlds.main

    def spy(argv):
        calls.append((argv, real_main(argv)))
        return calls[-1][1]

    monkeypatch.setattr(run_worlds, "main", spy)
    out = tmp_path / "cmp.json"
    got = run_armtd_comparison.main([*SMALL, "--out", str(out)])
    monkeypatch.undo()
    with open(out) as f:
        assert json.load(f) == got
    with open(JAX_FILE) as f:
        jax_file = json.load(f)
    assert list(got) == ["armour", "armtd"]
    defaults = {"--worlds-dir": run_worlds.ASSETS, "--hlp": "straight"}
    for (argv, ret), (half, traj) in zip(calls, (("armour", "bernstein"), ("armtd", "orig"))):
        assert _flags(argv) == {**defaults, **_flags(SMALL), "--traj-type": traj}
        assert ret is got[half]
        assert set(got[half]) == set(jax_file[half]) | {"device", "protocol"}
        assert got[half]["traj_type"] == traj and got[half]["n_worlds"] == 2
    alone = run_worlds.main([*SMALL, "--traj-type", "orig"])
    assert _untimed(got["armtd"]) == _untimed(alone)


def test_default_out_is_not_the_jax_file():
    assert os.path.samefile(os.path.dirname(run_armtd_comparison.DEFAULT_OUT),
                            os.path.dirname(JAX_FILE))
    assert os.path.basename(run_armtd_comparison.DEFAULT_OUT).startswith("torch_")
    assert os.path.basename(run_armtd_comparison.DEFAULT_OUT) != os.path.basename(JAX_FILE)


def test_halves_merge_into_an_existing_out(tmp_path, monkeypatch):
    """``--halves`` runs a subset and keeps the other half of ``--out``."""
    calls = []

    def fake_main(argv):
        calls.append(argv)
        traj = argv[argv.index("--traj-type") + 1]
        return {"success": 1, "n_worlds": 1, "collision": 0, "torque_violation": 0,
                "stopped_safely": 0, "traj_type": traj}

    monkeypatch.setattr(run_worlds, "main", fake_main)
    out = str(tmp_path / "cmp.json")
    run_armtd_comparison.main(["--device", "cpu", "--halves", "armtd", "--out", out])
    got = run_armtd_comparison.main(["--device", "cpu", "--halves", "armour", "--out", out])
    assert [g["traj_type"] for g in got.values()] == ["bernstein", "orig"]
    assert len(calls) == 2 and all(a[a.index("--device") + 1] == "cpu" for a in calls)


def _record(traj_type, worlds, complete=None, wall=10.0):
    """A run_worlds record of the given (name, goal, stopped, iterations) rows."""
    rows = [dict(world=name, iterations=its, n_feasible_plans=its - 1, goal_reached=goal,
                 collision=False, torque_violation=False, joint_limit_violation=name.endswith("9"),
                 ultimate_bound_violation=False, stopped=stop, jl_overshoot=-0.1)
            for name, goal, stop, its in worlds]
    d = {"protocol": {"hlp": "straight"}, "traj_type": traj_type, "max_iterations": 500,
         "wall_seconds": wall, "device": "cpu", "worlds": rows}
    if complete is not None:
        d.update(complete=complete, iterations_run=120)
    return d


def test_join_world_subsets(tmp_path):
    """Disjoint ``--worlds`` subsets run side by side join into one record
    per half (``run_worlds --join``): rows sorted by world, totals
    recounted, the longest wall, and ``complete`` only when every part ran
    to its end; a comparison's halves join name by name."""
    a = _record("bernstein", [("w3", True, False, 40), ("w1", False, True, 12)], wall=30.0)
    b = _record("bernstein", [("w2", True, False, 90), ("w9", False, False, 500)])
    c = _record("orig", [("w1", True, False, 20), ("w2", False, False, 200)], complete=False)
    paths = []
    for i, d in enumerate(({"armour": a}, {"armour": b}, {"armtd": c}, c)):
        paths.append(str(tmp_path / f"p{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(d, f)
    out = str(tmp_path / "cmp.json")
    got = run_worlds.main(["--join", *paths[:3], "--out", out])
    with open(out) as f:
        assert json.load(f) == got
    assert list(got) == ["armour", "armtd"]
    armour, armtd = got["armour"], got["armtd"]
    assert [r["world"] for r in armour["worlds"]] == ["w1", "w2", "w3", "w9"]
    assert (armour["n_worlds"], armour["goal_reached"], armour["success"]) == (4, 2, 2)
    assert (armour["stopped_safely"], armour["joint_limit_violation"]) == (1, 1)
    assert armour["mean_iterations"] == (12 + 90 + 40 + 500) / 4
    assert armour["wall_seconds"] == 30.0 and armour["complete"] is True
    assert [p["worlds"] for p in armour["parts"]] == [["w3", "w1"], ["w2", "w9"]]
    assert armtd["complete"] is False and armtd["parts"][0]["iterations_run"] == 120
    joined = run_worlds.main(["--join", paths[3], "--out", str(tmp_path / "orig.json")])
    assert joined == armtd
    with pytest.raises(ValueError, match="overlap"):
        run_worlds.join([a, a])
    with pytest.raises(ValueError, match="mix"):
        run_worlds.join_files(paths[2:])


def test_battery_table_holds_world_by_world():
    """`battery_table` on the JAX package's two committed self-generated
    batteries: every world in one cell, the goal row and column summing to
    each record's goal count, the off-diagonal worlds listed by cell."""
    from armour_tpu_torch import battery_table

    r4, r5 = (os.path.join(ROOT, "results", f"r{i}_100worlds_selfgen.json") for i in (4, 5))
    got = battery_table.main([r4, r5])
    with open(r4) as f:
        a = json.load(f)
    with open(r5) as f:
        b = json.load(f)
    t = got["table"]
    assert got["worlds"] == 100 and sum(sum(row.values()) for row in t.values()) == 100
    assert sum(t["goal"].values()) == a["goal_reached"]
    assert sum(t[x]["goal"] for x in t) == b["goal_reached"]
    assert sum(t["stop"].values()) == sum(r["stopped"] and not r["goal_reached"] for r in a["worlds"])
    off = sum(len(ws) for ws in got["off_diagonal"].values())
    assert off == 100 - sum(t[x][x] for x in t)
    assert got["safety"][1] == {k: b[k] for k in battery_table.SAFETY}
