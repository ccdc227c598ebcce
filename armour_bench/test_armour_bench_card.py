"""One short run of each cell on the card (skips without one)."""

import json
import subprocess

import pytest

from armour_bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    man = harness.manifest()
    out = subprocess.run([*man["command"], "--workload", cell, "--seed", "4294967311",
                          "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(cell).end_to_end}
