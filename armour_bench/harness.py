"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

A run sets the cell up (the planner of its configuration, the traffic
pool from the seed, one first call per shape the traffic uses), measures
for ``--seconds`` with the trace off, and with ``--trace 1`` then replays a
short sub-window of the same traffic under ``torch.profiler`` (and, for
batched plans, with the program's build and solve marks).  Once the
window has closed and the peak memory is read, the program is freed and
the plain reference (``reference/check.py``) judges a sample of the
window's answers.  The last line of standard output is the result.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``end_to_end/<metric>.py`` and
``metrics/<metric>.py`` (each with a ``read(record)`` that returns the
number, or None where it finds nothing to read).

Only the program under test, ``armour_tpu_torch``, and its kernel names
and marks come from outside this folder.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from armour_bench import gen

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from, compared as whole names
FORBIDDEN = ("jax", "jaxlib", "flax", "armour_tpu")
SAMPLE_STREAM = 0xC4EC    # the check's sample is drawn from (seed, this)


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------

def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def named_file(kind: str, name: str, suffix: str = ".json") -> Path:
    """``<kind>/<name><suffix>`` under this folder; raises if missing."""
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"armour_bench: no {kind} file {path.relative_to(ROOT)}")
    return path


def load_reader(kind: str, name: str):
    """The ``read(record)`` function of ``<kind>/<name>.py``."""
    path = named_file(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"armour_bench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Cell(NamedTuple):
    name: str
    workload: dict      # workloads/<cell>.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    end_to_end: list    # the manifest's end-to-end metrics this cell reports
    per_layer: list     # the manifest's per-layer metrics this cell reports


def load_cell(name: str, man: dict | None = None) -> Cell:
    man = manifest() if man is None else man
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"armour_bench: BENCHMARK.json has no workload {name!r}")
    workload = read_json(named_file("workloads", name))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"armour_bench: workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json {entry[key]!r}")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, workload, read_json(named_file("configs", entry["config"])),
                read_json(named_file("traffic", entry["traffic"])), e2e, per_layer)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# statistics of a window
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all ``values``."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    return s[max(0, int(np.ceil(q / 100.0 * len(s))) - 1)]


# ---------------------------------------------------------------------------
# the entries the window drives
# ---------------------------------------------------------------------------

class BatchEntry:
    """``ArmourPlanner.plan_batch`` on batches of B worlds of the pool, kept
    on the card, cycled; every result's feasible count read back, as a
    battery's bookkeeping reads it."""

    def __init__(self, planner, pool: dict, starts: np.ndarray, batch: int):
        import torch

        self.planner, self.torch = planner, torch
        n = len(pool["q0"]) // batch
        dev = planner.device

        def put(x, dtype):
            t = torch.as_tensor(np.asarray(x)[: n * batch], dtype=dtype, device=dev)
            return t.reshape((n, batch) + t.shape[1:])

        self.inputs = [put(pool[k], torch.bool if k == "masks" else torch.float32) for k in gen.FIELDS]
        self.starts = put(starts, torch.float32)
        self.n, self.batch = n, batch

    def worlds(self, idx: int) -> range:
        return range(idx * self.batch, (idx + 1) * self.batch)

    def call(self, i: int):
        idx = i % self.n
        return idx, self.planner.plan_batch(*(x[idx] for x in self.inputs), k_rand=self.starts[idx])

    def traced_call(self, i: int, marks: dict | None):
        """The same plan through ``run_program`` (``plan_batch`` is its
        first output), for the marks and the bank's bucket."""
        idx = i % self.n
        res, prob = self.planner.run_program(*(x[idx] for x in self.inputs), self.starts[idx],
                                             marks=marks)
        return idx, res, int(prob.hp.A.shape[-2])

    def read_back(self, res) -> int:
        return int(res.feasible.sum())

    def rows(self, res) -> dict:
        return {"k": res.k, "feasible": res.feasible, "cost": res.cost,
                "max_violation": res.max_violation, "t_rad": res.torque_radius}


class ReplanEntry:
    """``ArmourPlanner.plan`` of one world at a time from the pool, held on
    the host (a robot's state and obstacle list arrive from the host); each
    plan's ``k`` and verdict read back to the host."""

    batch = 1

    def __init__(self, planner, pool: dict, starts: np.ndarray, batch: int = 1):
        from armour_tpu_torch.collision.zonotope import ObstacleSet

        if batch != 1:
            raise ValueError("the plan entry plans one world")
        self.planner, self.pool, self.starts = planner, pool, starts
        self.obstacles = ObstacleSet
        self.n = len(pool["q0"])

    def worlds(self, idx: int) -> range:
        return range(idx, idx + 1)

    def call(self, i: int):
        w = i % self.n
        p = self.pool
        return w, self.planner.plan(p["q0"][w], p["qd0"][w], p["qdd0"][w], p["q_des"][w],
                                    self.obstacles(p["zonos"][w], p["masks"][w]),
                                    k_rand=self.starts[w])

    def traced_call(self, i: int, marks: dict | None):
        """The same plan; ``plan`` takes no marks and reports no bank
        (a reader that needs the bucket finds None)."""
        w, res = self.call(i)
        return w, res, None

    def read_back(self, res) -> int:
        res.k.cpu()
        return int(res.feasible)

    def rows(self, res) -> dict:
        return {"k": res.k[None], "feasible": res.feasible[None], "cost": res.cost[None],
                "max_violation": res.max_violation[None], "t_rad": res.torque_radius[None]}


ENTRIES = {"plan_batch": BatchEntry, "plan": ReplanEntry}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def make_pool(cell: Cell, planner_cfg: dict, seed: int, device, batch: int) -> tuple:
    """The cell's traffic: ``pool_batches`` batches of ``batch`` worlds and
    their random starts, from the seed."""
    tr = cell.traffic
    n = tr["pool_batches"] * batch
    pool = gen.worlds(n, tr["live_obstacles"], planner_cfg["k_range"],
                      planner_cfg["max_obstacles"], seed, device)
    starts = gen.starts(n, max(planner_cfg["nlp_num_starts"] - 2, 1), 7, seed)
    return pool, starts


def timed_window(entry, seconds: float, first: int, min_calls: int = 1) -> dict:
    """Back-to-back calls for ``seconds`` (closed loop, one caller), and at
    least ``min_calls``, each timed from its call to its result on the
    host."""
    log = []
    i = first
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        idx, res = entry.call(i)
        feasible = entry.read_back(res)
        t1 = time.perf_counter()
        log.append({"idx": idx, "res": res, "t0": t0, "t1": t1, "feasible": feasible,
                    "answers": entry.batch})
        i += 1
        if t1 - t_start >= seconds and len(log) >= min_calls:
            break
    return {"t_start": t_start, "t_end": log[-1]["t1"], "calls": log, "next": i}


def speed_record(calls: list, n: int = 10) -> dict:
    """The pace of a window's calls, host clock: the median call of the
    first and of the last ``n``, the median of all, and the calls whose
    time lies nearer the slowest than the fastest.  A run whose device
    turns faster part-way shows it here."""
    took = [c["t1"] - c["t0"] for c in calls]
    lo, hi = min(took), max(took)
    return {"first10_s": float(np.median(took[:n])), "last10_s": float(np.median(took[-n:])),
            "median_s": float(np.median(took)),
            "slow_calls": sum(1 for t in took if t - lo > hi - t), "calls": len(took)}


def traced_window(entry, sub: dict, first: int, device) -> tuple:
    """The traced run's sub-window: ``mark_calls`` plans with the program's
    build and solve marks, then ``profile_calls`` plans under the profiler.
    Returns (marks, profile record, next call index)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    i = first
    marks = []
    for _ in range(sub.get("mark_calls", 0)):
        m = {}
        sync()
        t0 = time.perf_counter()
        _, res, bucket = entry.traced_call(i, m)
        entry.read_back(res)
        marks.append({"start": t0, "bucket": bucket, **m})
        i += 1
    calls = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function("armour_bench.window"):
            for _ in range(sub["profile_calls"]):
                with record_function("armour_bench.call"):
                    _, res, bucket = entry.traced_call(i, None)
                    entry.read_back(res)
                calls.append({"bucket": bucket, "answers": entry.batch})
                i += 1
    return marks, profile_record(prof, calls), i


def profile_record(prof, calls: list) -> dict:
    """Device activity and host spans of a profiled sub-window, in seconds
    from its start: {"window_s", "calls" (with "start", "end"), "device"
    [(name, start, duration)], "host" [(name, start, duration)],
    "busy_s"}."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window, spans = [], [], None, []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == cuda:
            # the harness's own spans are mirrored on the device's timeline
            # as annotations: they are no device activity
            if not (name.startswith("armour_bench.") or _user_annotation(e)):
                device.append((name, start, dur))
            continue
        if name == "armour_bench.window":
            window = (start, start + dur)
        elif name == "armour_bench.call":
            spans.append((start, start + dur))
        else:
            host.append((name, start, dur))
    if window is None:
        raise RuntimeError("armour_bench: the profiled window left no span")
    t0, t1 = window
    by_start = lambda x: (x[1], x[2])  # noqa: E731
    device = sorted(((n, s - t0, d) for n, s, d in device if s + d > t0 and s < t1), key=by_start)
    host = sorted(((n, s - t0, d) for n, s, d in host if s + d > t0 and s < t1), key=by_start)
    for c, (s, e) in zip(calls, sorted(spans)):
        c.update(start=s - t0, end=e - t0)
    # the union of device activity inside the window
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, d in device:
        s, e = max(s, 0.0), min(s + d, t1 - t0)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"window_s": t1 - t0, "calls": calls, "device": device, "host": host, "busy_s": busy}


def _user_annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def breakdown(prof: dict, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps of the device labelled by the innermost host operation under
    their middle."""
    by_name: dict = {}
    for name, _, d in prof["device"]:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], 0.0
    for _, s, d in prof["device"]:
        if s > end:
            gaps.append((end, s))
        end = max(end, s + d)
    if prof["window_s"] > end:
        gaps.append((end, prof["window_s"]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        under = [(d, n) for n, hs, d in prof["host"] if hs <= mid <= hs + d]
        label = min(under)[1] if under else "host (no traced operation)"
        idle.append([label[:200], e - s])
    return {"device_ops": [[n[:200], t] for n, t in ops], "idle_gaps": idle}


def last_answers(entry, calls: list) -> tuple:
    """({pool world: row index}, rows stacked over the last answer of each
    pool entry, the count of earlier answers of an entry that differ from
    its last in any bit)."""
    import torch

    last = {}
    for c in calls:
        last[c["idx"]] = c["res"]
    mismatch = 0
    for c in calls:
        ref = last[c["idx"]]
        if c["res"] is not ref:
            a, b = entry.rows(c["res"]), entry.rows(ref)
            same = all(torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
                       for x, y in zip(a.values(), b.values()))
            mismatch += 0 if same else 1
    where, rows = {}, {}
    for idx, res in last.items():
        for j, w in enumerate(entry.worlds(idx)):
            where[w] = (idx, j)
    for key in ("k", "feasible", "cost", "max_violation", "t_rad"):
        rows[key] = {idx: entry.rows(res)[key] for idx, res in last.items()}
    return where, rows, mismatch


def check(cell: Cell, pool: dict, entry, window: dict, seed: int, device) -> tuple:
    """The reference's judgement of a sample, drawn from the seed, of the
    worlds the window answered (the last answer of each)."""
    import torch

    from armour_bench.reference import check as ref_check
    from armour_bench.reference.config import PlannerConfig as RefConfig
    from armour_bench.reference.kinova import kinova_gen3_spec as ref_spec

    where, rows, mismatch = last_answers(entry, window["calls"])
    answered = np.array(sorted(where))
    rng = np.random.default_rng([*gen.seed_words(seed), SAMPLE_STREAM])
    n = min(cell.workload["check"]["worlds"], len(answered))
    sample = np.sort(rng.choice(answered, size=n, replace=False))
    answers = {key: torch.stack([rows[key][where[w][0]][where[w][1]] for w in sample]).cpu()
               for key in rows}
    inputs = {k: pool[k][sample] for k in gen.FIELDS}
    for c in window["calls"]:
        c["res"] = None
    cfg = RefConfig(**cell.config["planner"])
    numbers = ref_check.judge(ref_spec(), cfg, inputs, answers, device,
                              viol_above=cell.workload["check"].get("viol_above"))
    numbers["repeat_mismatch"] = mismatch
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): each number of the cell's
    limits at most its limit."""
    compared = [[k, numbers[k], lim] for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in compared), compared


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def open_cell(name: str, device=None, overrides: dict | None = None) -> tuple:
    """(cell, planner, batch, device) of cell ``name``: its files read and
    the program's planner of its configuration made.  ``device`` None means
    the card; ``overrides`` ({"planner": {...}, "batch": b, "pool_batches":
    n, "check_worlds": m, "warmup_until_s": s}) shrink a cell for the CPU
    tests, never in a measured run."""
    import torch

    import armour_tpu_torch  # noqa: F401  (sets the program's matmul precision)
    from armour_tpu_torch.config import PlannerConfig
    from armour_tpu_torch.planner.armour import ArmourPlanner
    from armour_tpu_torch.robots.kinova import kinova_gen3_spec

    cell = load_cell(name)
    overrides = overrides or {}
    planner_cfg = {**cell.config["planner"], **overrides.get("planner", {})}
    cell = cell._replace(
        config={**cell.config, "planner": planner_cfg},
        traffic={**cell.traffic, **({"pool_batches": overrides["pool_batches"]}
                                    if "pool_batches" in overrides else {})},
        workload={**cell.workload, "check": {**cell.workload["check"],
                                             **({"worlds": overrides["check_worlds"]}
                                                if "check_worlds" in overrides else {})},
                  **({"warmup_until_s": overrides["warmup_until_s"]}
                     if "warmup_until_s" in overrides else {})})
    batch = overrides.get("batch", cell.config["batch"])
    dev = torch.device("cuda" if device is None else device)
    dtype = getattr(torch, cell.config["dtype"])
    planner = ArmourPlanner(kinova_gen3_spec(), PlannerConfig(**planner_cfg), dtype=dtype, device=dev)
    return cell, planner, batch, dev


def pace_turned(took: list, share: float, n: int = 3) -> bool:
    """Whether the median of the last ``n`` call times lies ``share`` or
    more below the slowest median of ``n`` consecutive calls before them
    (a median of three is blind to one stalled call)."""
    if len(took) < 2 * n:
        return False
    slowest = max(float(np.median(took[j:j + n])) for j in range(len(took) - 2 * n + 1))
    return float(np.median(took[-n:])) <= (1.0 - share) * slowest


def start_traffic(cell: Cell, planner, batch: int, seed: int, stamps: list | None = None,
                  t_proc: float | None = None) -> tuple:
    """(pool, entry) of the seed, after the cell's warm-up calls (one first
    call per shape the traffic uses) and, given the clock at which the
    process started, more calls of the traffic until the cell's
    ``warmup_until_s`` after it.  A process's plans run at a slow pace on
    the card for its first 20-70 s, then at a faster one for good
    (PERF.md); where the cell gives ``warmup_turn_share``, the warm-up also
    runs on until the pace of its calls has fallen by that share
    (``pace_turned``), or for ``warmup_cap_s`` after the shape calls, so
    that the window measures the steady pace.  ``stamps`` receives the host
    clock after the pool and after each warm-up call."""
    import torch

    stamps = [] if stamps is None else stamps
    pool, starts = make_pool(cell, cell.config["planner"], seed, planner.device, batch)
    entry = ENTRIES[cell.workload["entry"]](planner, pool, starts, batch)
    stamps.append(("pool", time.perf_counter()))
    first = cell.workload["warmup_batches"]
    for i in range(first):
        entry.read_back(entry.call(i)[1])
        stamps.append((f"warm-up {i}", time.perf_counter()))
    until = cell.workload.get("warmup_until_s")
    share = cell.workload.get("warmup_turn_share")
    t_cap = time.perf_counter() + cell.workload.get("warmup_cap_s", 0)
    took, turned = [], False

    def more() -> bool:
        t = time.perf_counter()
        if t_proc is None or not until:
            return False
        return t - t_proc < until or (bool(share) and not turned and t < t_cap)

    i = first
    while more():
        t0 = time.perf_counter()
        entry.read_back(entry.call(i)[1])
        took.append(time.perf_counter() - t0)
        turned = turned or bool(share) and pace_turned(took, share)
        i += 1
    if i > first:
        stamps.append((f"{i - first} more calls", time.perf_counter()))
    if share and took:
        stamps.append((f"pace {'turned' if turned else 'not turned'}, last calls "
                       f"{float(np.median(took[-3:])):.4f} s", time.perf_counter()))
    if planner.device.type == "cuda":
        torch.cuda.synchronize(planner.device)
    return pool, entry


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_proc: float,
             device=None, overrides: dict | None = None, log=print) -> dict:
    """One run of cell ``name``: the result's dict (without printing it);
    ``device`` and ``overrides`` as ``open_cell``'s."""
    import torch

    cell, planner, batch, dev = open_cell(name, device, overrides)
    stamps = [("planner", time.perf_counter())]
    on_card = dev.type == "cuda"
    planner_cfg = cell.config["planner"]
    pool, entry = start_traffic(cell, planner, batch, seed, stamps, t_proc)
    setup_s = time.perf_counter() - t_proc
    steps = ", ".join(f"{k} {t - t_proc:.2f}" for k, t in stamps)
    log(f"armour_bench: {name} seed {seed}: set-up {setup_s:.3f} s ({steps})", file=sys.stderr)

    window = timed_window(entry, seconds, cell.workload["warmup_batches"])
    took = sorted(c["t1"] - c["t0"] for c in window["calls"])
    speed = speed_record(window["calls"])
    log(f"armour_bench: window {window['t_end'] - window['t_start']:.3f} s, {len(took)} calls, "
        f"call s min {took[0]:.4f} median {took[len(took) // 2]:.4f} max {took[-1]:.4f}; "
        f"median of the first 10 {speed['first10_s']:.4f}, of the last 10 {speed['last10_s']:.4f}",
        file=sys.stderr)
    record = {"setup_s": setup_s, **window}
    e2e = {m["name"]: load_reader("end_to_end", m["name"])(record) for m in cell.end_to_end}

    out_metrics, dev_info, brk = {}, {}, None
    if trace:
        marks, prof, _ = traced_window(entry, cell.workload["trace"], window["next"], dev)
        layer_record = {"marks": marks, "profile": prof, "config": cell.config,
                        "planner": planner_cfg, "batch": batch,
                        "peaks": _peaks(torch, dev) if on_card else None}
        for m in cell.per_layer:
            value = load_reader("metrics", m["name"])(layer_record)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}
        brk = breakdown(prof)
    else:
        for m in cell.end_to_end:
            out_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    attempted = sum(c["answers"] for c in window["calls"])
    entry.planner = None          # the program's state goes before the reference runs
    del planner
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check(cell, pool, entry, window, seed, dev)
    log(f"armour_bench: the reference's check took {time.perf_counter() - t_check:.3f} s",
        file=sys.stderr)
    del entry
    correct, compared = verdict(numbers, cell.workload["check"]["limits"])
    log(f"armour_bench: check detail {json.dumps(numbers)}", file=sys.stderr)
    result = {
        "correct": correct, "attempted": attempted, "failed": 0, "metrics": out_metrics,
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **dev_info},
    }
    if on_card:
        result["card"] = nvidia_smi()
    if brk is not None:
        result["breakdown"] = brk
    result["speed"] = speed
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    return result


def _peaks(torch, dev) -> dict:
    from armour_bench.roofline import peaks

    return peaks(torch.cuda.get_device_name(dev))


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None, t_proc: float | None = None) -> int:
    t_proc = time.perf_counter() if t_proc is None else t_proc
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"armour_bench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"armour_bench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_proc)
    except ForbiddenModules as e:
        print(f"armour_bench: modules of JAX or the JAX package were loaded: {e.args[0]}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
