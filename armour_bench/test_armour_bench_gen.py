"""The traffic generator repeats from its seed, takes any whole number as
a seed, and is the program's own problem stream frozen."""

import math

import numpy as np
import pytest

from armour_bench import gen

K_RANGE = math.pi / 48


def test_the_same_seed_gives_the_same_traffic():
    a = gen.worlds(6, 8, K_RANGE, 40, 2**31 + 12345, "cpu")
    b = gen.worlds(6, 8, K_RANGE, 40, 2**31 + 12345, "cpu")
    c = gen.worlds(6, 8, K_RANGE, 40, 2**31 + 12346, "cpu")
    for k in gen.FIELDS:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["q0"], c["q0"])
    s1, s2 = gen.starts(6, 2, 7, 77), gen.starts(6, 2, 7, 77)
    np.testing.assert_array_equal(s1, s2)
    assert s1.shape == (6, 2, 7) and s1.min() >= -0.6 and s1.max() < 0.6
    assert not np.array_equal(s1, gen.starts(6, 2, 7, 78))


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1, 2**32, 2**31 * 3 + 7, 10**30, -5])
def test_any_whole_number_is_a_seed(seed):
    w = gen.worlds(2, 4, K_RANGE, 40, seed, "cpu")
    assert w["zonos"].shape == (2, 40, 4, 3) and w["masks"].sum(1).max() <= 4
    assert gen.starts(2, 2, 7, seed).shape == (2, 2, 7)


def test_the_seed_stream_is_the_programs_problem_set():
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.problems import problem_set

    for n_obs, seed in ((8, 0), (40, 7)):
        p = problem_set(PlannerConfig(), 5, n_obs=n_obs, seed=seed, device="cpu")
        w = gen.worlds(5, n_obs, K_RANGE, 40, seed, "cpu")
        for k in gen.FIELDS:
            np.testing.assert_array_equal(getattr(p, k), w[k])


def test_obstacles_clear_the_start_and_fill_the_slots():
    w = gen.worlds(8, 8, K_RANGE, 40, 3, "cpu")
    assert (w["masks"].sum(1) == 8).all()
    assert not w["masks"][:, 8:].any()
    np.testing.assert_allclose(w["q_des"] - w["q0"], np.clip(w["q_des"] - w["q0"], -K_RANGE, K_RANGE))
