"""The battery probe (``python -m armour_tpu_torch.profile_battery``) on the
CPU at a small size: 1 world of `assets/worlds`, T=16, 1 iteration, the box
oracle, run through ``--tree`` on this checkout in a process of its own (the
option re-imports the package); then 2 iterations with the host profiled
from the second.  No JAX here.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def test_profile_battery_prints_the_wall_split_of_each_iteration():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "armour_tpu_torch.profile_battery", "--device", "cpu",
         "--iterations", "1", "--max-worlds", "1", "--time-steps", "16",
         "--collision-oracle", "box", "--tree", ROOT],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["tree"] == ROOT and out["worlds"] == 1 and out["max_allocated_gib"] is None
    (it,) = out["iterations"]
    assert set(it) == {"ref_waypoints_s", "build_probs_s", "solve_s", "roll_and_check_s",
                       "mesh_refine_s", "host_s", "wall_s", "active"}
    assert all(v > 0 for v in it.values())
    assert it["build_probs_s"] + it["solve_s"] + it["roll_and_check_s"] <= it["wall_s"]
    assert it["wall_s"] <= out["seconds"]
    assert "host_profile" not in out


def test_profile_battery_profiles_a_late_slice():
    """``--profile-from 1``: the host guidance phases by name over the
    profiled slice (iteration 1 of 2), each within the run's seconds."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "armour_tpu_torch.profile_battery", "--device", "cpu",
         "--iterations", "2", "--max-worlds", "1", "--time-steps", "16",
         "--collision-oracle", "box", "--profile-from", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(out["iterations"]) == 2
    prof = out["host_profile"]
    assert prof["from"] == 1 and prof["iterations"] == 1
    assert prof["wall_s"] == out["iterations"][1]["wall_s"]
    phases = prof["phase_s"]
    assert set(phases) == {"rrt_connect", "rrt_star", "ee_rrt_star", "ee_rrt_star_config", "ik",
                           "clearance_waypoint", "mesh_oracle", "ee_waypoints"}
    assert all(0.0 <= v <= prof["wall_s"] for v in phases.values())
