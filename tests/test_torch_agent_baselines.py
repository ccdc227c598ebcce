"""Parity of the port's closed-loop ``rollout`` with the JAX package for the
three baseline controllers (nominal passivity, PID, iLQR), on the CPU in
float64; the nominal law runs on the 'orig' trajectory family.  The case,
the comparison and the tolerances (1e-7 after 100 RK4 steps) are those of
`test_torch_agent.py`; the cases live in a file of their own because the
JAX side compiles each rollout for most of a minute.
"""

import pytest

from test_torch_agent import check_rollout_matches_jax, one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("controller,traj_type", [
    ("nominal", "orig"), ("pid", "bernstein"), ("ilqr", "bernstein")])
def test_rollout_matches_jax(controller, traj_type):
    check_rollout_matches_jax(controller, traj_type)
