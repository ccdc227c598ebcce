"""The port's problem generator against the JAX benchmark's, on the CPU.

`armour_tpu_torch.problems.problem_set` keeps `bench.py::_problem_set`'s
numpy random stream and its start-volume rejection screen, so the same
seed gives the same worlds.  The arrays are compared exactly: both draw
the same numbers, and the screen's float32 verdicts agree unless an
obstacle grazes the arm to within float32 rounding.
"""

import importlib.util
import os

import numpy as np
import pytest

from armour_tpu.config import PlannerConfig as JaxPlannerConfig
from armour_tpu_torch.config import PlannerConfig
from armour_tpu_torch.problems import problem_set

_BENCH = os.path.join(os.path.dirname(__file__), "..", "bench.py")


def _bench():
    spec = importlib.util.spec_from_file_location("bench_for_port_test", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_obs,seed", [(8, 0), (40, 7)])
def test_problem_set_matches_bench(n_obs, seed):
    ref = _bench()._problem_set(JaxPlannerConfig(num_time_steps=16), 4, n_obs=n_obs, seed=seed)
    got = problem_set(PlannerConfig(num_time_steps=16), 4, n_obs=n_obs, seed=seed, device="cpu")
    assert len(ref) == len(got)
    for name, r, g in zip(got._fields, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g, err_msg=name)
    assert got.masks.sum(axis=1).min() > 0
