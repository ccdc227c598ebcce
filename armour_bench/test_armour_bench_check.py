"""The correctness check fails what it has to fail.  Each run here drives
the rest of a run on the CPU at a small size (T = 16, a few worlds),
skipping the harness's look for a card: a sound run comes out correct;
the control (the program with TF32 matrix products, emulated on the CPU)
and each fault planted in the timed path come out not correct, and a
hyperplane bank one precision below the configuration's moves the
constraint values that the check compares."""

import functools
import time

import pytest
import torch

from armour_bench import calibrate, harness
from armour_bench.control import altered_answer, state_unchanged

CELLS = ("batch128_8obs", "realtime_8obs")


def _overrides(cell):
    batch = cell.startswith("batch")
    return {"planner": {"num_time_steps": 16}, "batch": 4 if batch else 1,
            "pool_batches": 2 if batch else 3, "check_worlds": 8, "warmup_until_s": 0}


def _run(cell):
    return harness.run_cell(cell, 20261019, 0.1, False, time.perf_counter(), device="cpu",
                            overrides=_overrides(cell), log=lambda *a, **k: None)


def _left_out(res, rows):
    """The plan with ``rows`` (a bool mask over its worlds) never answered."""
    from armour_tpu_torch.planner.armour import PlanResult

    batched = res.feasible.ndim == 1
    m = rows if batched else rows[0]
    pick = lambda x, v: torch.where(m.reshape(m.shape + (1,) * (x.ndim - m.ndim)), v, x)  # noqa: E731
    return PlanResult(k=pick(res.k, torch.nan), feasible=pick(res.feasible, False),
                      cost=pick(res.cost, torch.inf), max_violation=pick(res.max_violation, torch.inf),
                      torque_radius=pick(res.torque_radius, 0.0))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0


def _readings(cell, control, monkeypatch):
    # a window that answers every world of the robot's pool: an obstacle
    # box's own faces have normals that every precision holds exactly
    monkeypatch.setattr(harness, "timed_window", functools.partial(harness.timed_window, min_calls=3))
    return calibrate.readings(cell, [20261019], 0.1, control=control, device="cpu",
                              overrides=_overrides(cell))[0]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, monkeypatch):
    row = _readings(cell, "tf32", monkeypatch)
    assert not row["correct"], row


@pytest.mark.parametrize("cell", CELLS)
def test_a_bank_one_precision_below_moves_the_constraint_values(cell, monkeypatch):
    # at this size the bank's controls move viol_gap several times over the
    # sound run's; the limit itself is set from their readings on the card,
    # at the cell's size, where they read 2.6 to 9.5 times the sound runs'
    sound = _readings(cell, None, monkeypatch)
    assert sound["correct"], sound
    for control in ("fp8_normals", "bf16_offsets"):
        row = _readings(cell, control, monkeypatch)
        assert row["viol_gap"] > 2.5 * sound["viol_gap"], (control, row, sound)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from armour_tpu_torch.planner import armour

    if fault == "state_unchanged":
        # the solver's Gauss-Newton step returns its state unchanged
        with state_unchanged():
            out = _run(cell)
        assert not out["correct"], out["checks"]
        return
    name = "plan_batch" if cell.startswith("batch") else "plan"
    entry = getattr(armour.ArmourPlanner, name)
    calls = []

    def broken(self, *args, **kwargs):
        res = entry(self, *args, **kwargs)
        calls.append(1)
        if fault == "answer_altered":
            return altered_answer(res)
        # half of the batch, or every other request of one robot, unanswered
        n = res.feasible.numel()
        rows = (torch.arange(n) >= n // 2) if n > 1 else torch.tensor([len(calls) % 2 == 1])
        return _left_out(res, rows)

    monkeypatch.setattr(armour.ArmourPlanner, name, broken)
    out = _run(cell)
    assert not out["correct"], out["checks"]
