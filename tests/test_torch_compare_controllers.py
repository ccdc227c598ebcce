"""The port's controller sweep against the committed JAX table, on the CPU.

``armour_tpu_torch.compare_controllers`` draws its trajectories and scales
from ``numpy.random.default_rng(0)`` in the JAX script's order, so its rows
can be held to `results/r4_controller_sweep.json` (16 trajectories, 1,000
RK4 steps, float32).  Two rows run here, ``robust`` at 0 % (inside the
ultimate bound) and ``pid`` at 50 % (outside it): the earlier levels'
scales are drawn first, so the stream lines up with the full sweep.  Each
row's ``within_ultimate_bound`` flag must equal the committed one, and its
errors must lie within 1e-2 relative (``chip_smoke.SWEEP_RTOL``): the file
does not record the platform that wrote it, and float32 sums in another
order moved the errors by up to 2.1e-3 relative on the CPU (all five
controllers at 0 % and 50 %).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from armour_tpu_torch import compare_controllers as cc
from armour_tpu_torch.robots.kinova import kinova_gen3_spec

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def committed():
    with open(ROOT / "results" / "r4_controller_sweep.json") as f:
        table = json.load(f)
    return table, {(r["controller"], r["uncertainty"]): r for r in table["rows"]}


@pytest.mark.parametrize("controller, uncertainty", [("robust", 0.0), ("pid", 0.5)])
def test_sweep_row_matches_the_committed_table(committed, controller, uncertainty):
    table, rows = committed
    spec = kinova_gen3_spec()
    assert table["n_trajectories"] == 16 and table["pos_bound"] == spec.qe
    rng = np.random.default_rng(0)
    traj = cc.reference_trajectories(rng, 16)
    for unc in cc.UNCERTAINTY:                     # the earlier levels' draws first
        scale = cc.true_scales(rng, 16, unc)
        if unc == uncertainty:
            break
    (row,) = cc.tracking_rows(spec, traj, [scale], [uncertainty], controller, torch.float32, "cpu")
    ref = rows[(controller, uncertainty)]
    assert row["within_ultimate_bound"] == ref["within_ultimate_bound"]
    assert row["within_ultimate_bound"] == (controller == "robust")
    for key in ("max_pos_err", "mean_pos_err", "max_vel_err"):
        np.testing.assert_allclose(row[key], ref[key], rtol=RTOL, atol=0, err_msg=key)
    assert set(row) == set(ref)
