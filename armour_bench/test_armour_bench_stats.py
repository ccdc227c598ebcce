"""The end-to-end arithmetic: a rate over all the work and all the time of
the window, a tail over all requests."""

import pytest

from armour_bench import harness


def _record(latencies, feasible=None, answers=1):
    t, calls = 0.0, []
    for i, lat in enumerate(latencies):
        calls.append({"t0": t, "t1": t + lat, "feasible": answers if feasible is None else feasible[i],
                      "answers": answers})
        t += lat
    return {"t_start": 0.0, "t_end": t, "calls": calls, "setup_s": 12.5}


def _read(name, record):
    return harness.load_reader("end_to_end", name)(record)


def test_percentile_is_nearest_rank_over_all_values():
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert harness.percentile(list(range(1, 101)), 95) == 95
    assert harness.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        harness.percentile([], 95)


def test_one_stalled_request_moves_the_tail():
    steady = [0.2] * 19
    assert _read("plan_p95_ms", _record(steady)) == pytest.approx(200.0)
    stalled = steady[:7] + [1.5] + steady[8:]
    assert _read("plan_p95_ms", _record(stalled)) == pytest.approx(1500.0)


def test_the_tail_counts_every_request_of_the_window():
    # 100 requests: the 95th percentile is the 95th fastest, so 5 stalls
    # stay beyond it and a 6th comes into it, wherever in the window it falls
    base = [0.2] * 100
    five = [1.0 if i % 20 == 3 else 0.2 for i in range(100)]
    six = list(five)
    six[98] = 1.0
    assert _read("plan_p95_ms", _record(base)) == pytest.approx(200.0)
    assert _read("plan_p95_ms", _record(five)) == pytest.approx(200.0)
    assert _read("plan_p95_ms", _record(six)) == pytest.approx(1000.0)


def test_the_rate_is_over_all_the_time_of_the_window():
    r = _record([0.5] * 10, feasible=[128] * 10, answers=128)
    assert _read("safe_plans_per_s", r) == pytest.approx(256.0)
    # one stalled batch lowers the rate by the time it took
    r = _record([0.5] * 9 + [2.5], feasible=[128] * 10, answers=128)
    assert _read("safe_plans_per_s", r) == pytest.approx(1280 / 7.0)
    # infeasible plans earn nothing
    r = _record([0.5] * 10, feasible=[64] * 10, answers=128)
    assert _read("safe_plans_per_s", r) == pytest.approx(128.0)


def test_setup_is_read_as_taken():
    assert _read("setup_s", _record([0.1])) == 12.5


def test_the_pace_of_a_window_shows_a_device_that_turns_faster():
    took = [0.207] * 30 + [0.178] * 200
    speed = harness.speed_record(_record(took)["calls"])
    assert speed["first10_s"] == pytest.approx(0.207) and speed["last10_s"] == pytest.approx(0.178)
    assert speed["median_s"] == pytest.approx(0.178)
    assert speed["slow_calls"] == 30 and speed["calls"] == 230


def test_the_warm_up_runs_the_traffic_until_its_time_after_the_process_start(monkeypatch):
    import time
    from types import SimpleNamespace

    import torch

    calls = []

    class Entry:
        def __init__(self, *args):
            pass

        def call(self, i):
            calls.append(i)
            time.sleep(0.01)
            return i, None

        def read_back(self, res):
            return 0

    monkeypatch.setattr(harness, "make_pool", lambda *args: ({}, None))
    monkeypatch.setitem(harness.ENTRIES, "fake", Entry)
    cell = harness.Cell("c", {"entry": "fake", "warmup_batches": 2, "warmup_until_s": 0.2},
                        {"planner": {}}, {}, [], [])
    planner = SimpleNamespace(device=torch.device("cpu"))
    t = time.perf_counter()
    harness.start_traffic(cell, planner, 1, 5, t_proc=t)
    assert time.perf_counter() - t >= 0.2 and calls[:2] == [0, 1] and len(calls) > 2
    calls.clear()
    harness.start_traffic(cell, planner, 1, 5)   # no clock of the process: the shapes alone
    assert calls == [0, 1]


def test_a_pace_turns_when_its_calls_fall_by_the_share_and_not_for_one_stall():
    assert harness.pace_turned([0.435] * 5 + [0.382] * 3, 0.06)
    assert not harness.pace_turned([0.435] * 8, 0.06)
    assert not harness.pace_turned([0.435] * 5 + [0.382] * 1, 0.06)   # too few fast calls
    assert not harness.pace_turned([0.382] * 4 + [8.7] + [0.382] * 3, 0.06)   # one stall
    assert not harness.pace_turned([0.382] * 3, 0.06)


@pytest.mark.parametrize("slow_calls,turns", [(12, True), (10 ** 6, False)])
def test_the_warm_up_waits_for_the_pace_to_turn_or_for_its_cap(monkeypatch, slow_calls, turns):
    import time
    from types import SimpleNamespace

    import torch

    calls = []

    class Entry:
        def __init__(self, *args):
            pass

        def call(self, i):
            calls.append(i)
            time.sleep(0.02 if len(calls) <= slow_calls else 0.01)
            return i, None

        def read_back(self, res):
            return 0

    monkeypatch.setattr(harness, "make_pool", lambda *args: ({}, None))
    monkeypatch.setitem(harness.ENTRIES, "fake", Entry)
    cell = harness.Cell("c", {"entry": "fake", "warmup_batches": 2, "warmup_until_s": 0.05,
                              "warmup_turn_share": 0.2, "warmup_cap_s": 1.0},
                        {"planner": {}}, {}, [], [])
    planner = SimpleNamespace(device=torch.device("cpu"))
    stamps = []
    t = time.perf_counter()
    harness.start_traffic(cell, planner, 1, 5, stamps, t_proc=t)
    took = time.perf_counter() - t
    last = stamps[-1][0]
    if turns:
        # the floor passes during the slow calls; the warm-up ends three fast calls after the turn
        assert "pace turned" in last and slow_calls + 2 <= len(calls) <= slow_calls + 4 and took < 0.9
    else:
        assert "not turned" in last and took >= 1.0
