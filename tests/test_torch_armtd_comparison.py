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
