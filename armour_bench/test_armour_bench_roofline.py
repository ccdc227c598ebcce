"""The bank pass's work counted from shapes, the peaks table, and the
readers of the traced sub-window."""

import pytest

from armour_bench import harness, roofline, trace

H100 = "NVIDIA H100 80GB HBM3"


def test_bank_pass_bytes_match_the_kernel_table():
    # PERF.md's kernel table: S = 4 with the Jacobian, B = 128, T = 128, bf16 A, f32 offsets
    assert roofline.bank_pass_bytes(128, 4, 36, 7, 8, 128, 7, True) == 623_902_720
    assert roofline.bank_pass_bytes(128, 4, 36, 7, 16, 128, 7, True) == 1_203_765_248
    assert roofline.bank_pass_bytes(128, 4, 36, 7, 8, 128, 7, False) == 482_607_104


def test_peaks_are_keyed_by_card_name_with_no_fallback():
    p = roofline.peaks(H100)
    assert p["bytes_per_s"] == 3.35e12 and p["f32_flops"] == 67e12
    with pytest.raises(RuntimeError):
        roofline.peaks("NVIDIA A100-SXM4-80GB")


def test_least_time_is_the_larger_bound():
    p = roofline.peaks(H100)
    least = roofline.bank_pass_least_s(p, 128, 4, 36, 7, 8, 128, 7, True)
    assert least == pytest.approx(623_902_720 / 3.35e12)   # bytes bound this launch
    ops = roofline.bank_pass_ops(128, 4, 36, 7, 8, 128, 7, True)
    assert ops / 67e12 < least


@pytest.mark.parametrize("name,kind", [
    ("void bank_pass<__nv_bfloat16, float, 4, true, 1>(BankArgs<float>)", (2, 4, True)),
    ("void bank_pass_small<__nv_bfloat16, float, 4, true>(SmallArgs<float>)", (2, 4, True)),
    ("void bank_pass<double, double, 16, false, 2>(BankArgs<double>)", (8, 8, False)),
    ("_Z9bank_passI13__nv_bfloat16fLi4ELb1ELi1EEv8BankArgsIfE", (2, 4, True)),
    ("void rollout_kernel<float, 4>(RolloutArgs)", None),
    ("void at::native::elementwise_kernel<128, 2>(int)", None),
])
def test_bank_pass_launches_are_told_from_kernel_names(name, kind):
    assert trace.bank_pass_kind(name, ("bank_pass", "bank_pass_small")) == kind


def _profile():
    jac = "void bank_pass<__nv_bfloat16, float, 4, true, 1>(BankArgs<float>)"
    device = [(jac, 0.000, 0.0003), ("void gemv<float>()", 0.0004, 0.0001), ("Memcpy DtoH", 0.0006, 0.00001),
              (jac, 0.0010, 0.0003), ("void gemv<float>()", 0.0014, 0.0001)]
    return {"window_s": 0.002, "busy_s": 0.00081,
            "calls": [{"bucket": 8, "answers": 128, "start": 0.0, "end": 0.0009},
                      {"bucket": 16, "answers": 128, "start": 0.0009, "end": 0.002}],
            "device": device, "host": [("cudaStreamSynchronize", 0.0015, 0.0004)]}


def test_readers_of_a_traced_sub_window():
    rec = {"profile": _profile(), "peaks": roofline.peaks(H100), "batch": 128,
           "planner": {"nlp_num_starts": 4, "num_time_steps": 128}, "marks": []}
    least = (623_902_720 + 1_203_765_248) / 3.35e12
    got = harness.load_reader("metrics", "bank_pass_roofline.batch")(rec)
    assert got == pytest.approx(100 * least / 0.0006)
    assert harness.load_reader("metrics", "kernels_per_plan.batch")(rec) == 2.0
    assert harness.load_reader("metrics", "device_idle_share.batch")(rec) == pytest.approx(59.5)
    assert harness.load_reader("metrics", "build_ms.batch")(rec) is None
    rec["marks"] = [{"start": 1.0, "built": 1.08, "solved": 1.44}, {"start": 2.0, "built": 2.1, "solved": 2.5}]
    assert harness.load_reader("metrics", "build_ms.batch")(rec) == pytest.approx(90.0)
    assert harness.load_reader("metrics", "solve_ms.batch")(rec) == pytest.approx(380.0)


def test_the_idle_share_leaves_out_the_profilers_own_stalls():
    # device busy 0-0.3, 0.5-0.6 and 0.9-1.0 ms of a 1 ms window: idle 0.5 ms,
    # of which 0.15 ms under a buffer request and 0.1 ms under a graph launch
    prof = {"window_s": 1e-3, "busy_s": 5e-4, "calls": [{"bucket": 8, "answers": 1}],
            "device": [("k", 0.0, 3e-4), ("k", 5e-4, 1e-4), ("k", 9e-4, 1e-4)],
            "host": [("Activity Buffer Request", 2.5e-4, 2e-4), ("cudaGraphLaunch", 6e-4, 1e-4),
                     ("cudaStreamSynchronize", 7e-4, 2e-4)]}
    assert trace.idle_share(prof) == pytest.approx(100 * 2.5e-4 / 7.5e-4)
    prof["host"] = prof["host"][2:]
    assert trace.idle_share(prof) == pytest.approx(50.0)


def test_the_roofline_finds_nothing_where_a_call_reports_no_bank():
    prof = _profile()
    prof["calls"][1]["bucket"] = None
    rec = {"profile": prof, "peaks": roofline.peaks(H100), "batch": 1,
           "planner": {"nlp_num_starts": 4, "num_time_steps": 128}, "marks": []}
    assert harness.load_reader("metrics", "bank_pass_roofline.batch")(rec) is None


def test_readers_find_nothing_without_device_activity():
    prof = {**_profile(), "device": [], "busy_s": 0.0}
    rec = {"profile": prof, "peaks": roofline.peaks(H100), "batch": 128,
           "planner": {"nlp_num_starts": 4, "num_time_steps": 128}, "marks": []}
    for name in ("bank_pass_roofline.batch", "kernels_per_plan.realtime", "device_idle_share.realtime"):
        assert harness.load_reader("metrics", name)(rec) is None


def test_breakdown_names_the_idle_gaps_by_the_host():
    b = harness.breakdown(_profile())
    assert b["device_ops"][0][0].startswith("void bank_pass")
    assert b["device_ops"][0][1] == pytest.approx(0.0006)
    # gaps: 0.0003-0.0004, 0.0005-0.0006, 0.00061-0.0010, 0.0013-0.0014 and
    # 0.0015-0.002, the last under the synchronise
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(0.0005)]
    assert b["idle_gaps"][1] == ["host (no traced operation)", pytest.approx(0.00039)]
    assert len(b["idle_gaps"]) == 5


class _Event:
    """A stand-in for one of the profiler's kineto events."""

    def __init__(self, name, start_us, dur_us, device, annotation=False):
        import torch

        kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
        self._v = (name, int(start_us * 1000), int(dur_us * 1000), kind, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_the_profile_record_orders_device_activity_by_time():
    from types import SimpleNamespace

    events = [
        _Event("armour_bench.window", 0, 1000, False),
        _Event("armour_bench.call", 10, 990, False),
        _Event("armour_bench.call", 10, 985, True, annotation=True),   # its mirror on the device
        _Event("zz_last_by_name", 100, 100, True),
        _Event("aa_first_by_name", 500, 200, True),
        _Event("mm_overlapping", 650, 100, True),
        _Event("cudaGraphLaunch", 20, 70, False),
        _Event("cudaStreamSynchronize", 760, 230, False),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    rec = harness.profile_record(prof, [{"bucket": 8, "answers": 128}])
    assert rec["window_s"] == pytest.approx(1e-3)
    assert [n for n, _, _ in rec["device"]] == ["zz_last_by_name", "aa_first_by_name", "mm_overlapping"]
    # the union: 100-200 and 500-750 us
    assert rec["busy_s"] == pytest.approx(350e-6)
    assert rec["calls"][0]["start"] == pytest.approx(10e-6)
    gaps = harness.breakdown(rec)["idle_gaps"]
    assert gaps[0] == ["host (no traced operation)", pytest.approx(300e-6)]
    assert gaps[1] == ["cudaStreamSynchronize", pytest.approx(250e-6)]
