"""The port's device-count scaling benchmark
(``python -m armour_tpu_torch.bench_scaling``, the counterpart of
`scripts/bench_scaling.py`) with ``--virtual 2``: one and then two gloo
ranks on the CPU, each running ``sharded_plan_step`` (cp = 1) on the JAX
script's problem at its small configuration.  The rows carry the keys of
`results/r5_scaling_virtual8.json`.  No JAX here.
"""

import json
import os

from armour_tpu_torch import bench_scaling

JAX_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "results",
                        "r5_scaling_virtual8.json")


def test_virtual_ranks_give_the_jax_rows(tmp_path):
    out = tmp_path / "scaling.json"
    got = bench_scaling.main(["--virtual", "2", "--reps", "1", "--timeout", "300", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == got
    with open(JAX_FILE) as f:
        jax_file = json.load(f)
    assert set(got) == set(jax_file)
    assert [r["devices"] for r in got["rows"]] == [1, 2]
    assert [r["worlds"] for r in got["rows"]] == [2, 4]
    for row in got["rows"]:
        assert set(row) == set(jax_file["rows"][0])
        assert row["plans_per_s"] > 0 and row["plans_per_s_per_device"] > 0
    assert (got["from_devices"], got["to_devices"]) == (1, 2)
    assert got["scaling_efficiency"] > 0
