"""Reductions of a profiled sub-window (``harness.profile_record``) shared by
the per-layer metric readers of ``metrics/``.

The device arithmetic is ``armour_tpu_torch/profile_plan.py::_traces``'s:
device time from the profiler's CUDA activity against the traced wall.
Busy time here is the union of the activity intervals (equal to their sum
on one stream, never above the window with several).  The idle share
leaves out the time the profiler itself holds the device idle (see
``PROFILER_STALLS``).
"""

from __future__ import annotations

import bisect
import re

from armour_bench.roofline import bank_pass_least_s

_NOT_KERNELS = ("Memcpy", "Memset")
# host operations whose length under the profiler is the profiler's own:
# its activity buffers, and graph launches, which its tracing of every
# node stretches to milliseconds (unprofiled, the host enqueues a plan's
# graph launches in a few milliseconds, ahead of the device)
PROFILER_STALLS = ("Activity Buffer Request", "Buffer Flush", "cudaGraphLaunch")
_TYPE_BYTES = {"__nv_bfloat16": 2, "13__nv_bfloat16": 2, "float": 4, "f": 4, "double": 8, "d": 8}
# bank_pass[_small]<A type, offsets' type, start bound, with Jacobian[, groups]>,
# demangled or mangled
_DEMANGLED = re.compile(r"\b(bank_pass(?:_small)?)<\s*([\w:]+)\s*,\s*([\w:]+)\s*,\s*(\d+)\s*,\s*(true|false)")
_MANGLED = re.compile(r"(bank_pass(?:_small)?)I(13__nv_bfloat16|f|d)(f|d)Li(\d+)ELb([01])E")


def is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


def kernels_per_call(prof: dict | None):
    """Device kernels of the sub-window per plan call; None without one."""
    if not prof or not prof["calls"] or not prof["device"]:
        return None
    return sum(1 for n, _, _ in prof["device"] if is_kernel(n)) / len(prof["calls"])


def union(intervals) -> list:
    """Sorted disjoint [start, end] covering ``intervals`` ((start, end))."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(prof: dict | None):
    """100 x idle / window in %, where the device ran nothing, with the
    time in which it idled while the host was inside one of
    ``PROFILER_STALLS`` left out of both; None without a sub-window."""
    if not prof or prof["window_s"] <= 0 or not prof["device"]:
        return None
    w = prof["window_s"]
    busy = union((max(s, 0.0), min(s + d, w)) for _, s, d in prof["device"])
    edges = [0.0] + [x for iv in busy for x in iv] + [w]
    idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    stalls = union((max(s, 0.0), min(s + d, w)) for n, s, d in prof["host"] if n in PROFILER_STALLS)
    hidden = overlap(idle, stalls)
    return 100.0 * (sum(e - s for s, e in idle) - hidden) / (w - hidden)


def bank_pass_kind(name: str, kernels: tuple):
    """(a_bytes, o_bytes, jac) of a launch of one of ``kernels``, else None."""
    m = _DEMANGLED.search(name)
    if m:
        kind, a, o, jac = m[1], m[2].split("::")[-1], m[3].split("::")[-1], m[5] == "true"
    else:
        m = _MANGLED.search(name)
        if not m:
            return None
        kind, a, o, jac = m[1], m[2], m[3], m[5] == "1"
    if kind not in kernels or a not in _TYPE_BYTES or o not in _TYPE_BYTES:
        return None
    return _TYPE_BYTES[a], _TYPE_BYTES[o], jac


def bank_pass_roofline(record: dict, kernels: tuple):
    """100 x (the least time of the sub-window's launches of ``kernels``) /
    (their device time).  A launch with the Jacobian is the solve's, at the
    configuration's starts; one of values only is the verification pool's,
    at 2 S + 2.  The shapes are the call's: B, its bank's bucket O, T, and
    the Kinova's P = 36 pairs, L = 7 links, n = 7 parameters.  None where
    there is no launch to read, or a call reports no bank."""
    prof, peak = record.get("profile"), record.get("peaks")
    if not prof or not peak or not prof["calls"]:
        return None
    cfg = record["planner"]
    S, T, B = cfg["nlp_num_starts"], cfg["num_time_steps"], record["batch"]
    starts = [c["start"] for c in prof["calls"]]
    least = measured = 0.0
    for name, s, d in prof["device"]:
        kind = bank_pass_kind(name, kernels)
        if kind is None:
            continue
        call = prof["calls"][max(0, bisect.bisect_right(starts, s) - 1)]
        if call["bucket"] is None:
            return None
        a_bytes, o_bytes, jac = kind
        least += bank_pass_least_s(peak, B, S if jac else 2 * S + 2, 36, 7, call["bucket"], T, 7, jac,
                                   a_bytes, o_bytes)
        measured += d
    return 100.0 * least / measured if measured > 0 else None
