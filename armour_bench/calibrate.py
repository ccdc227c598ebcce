"""The readings that the correctness check's limits are set from.

    python3 armour_bench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control tf32|fp8_normals|bf16_offsets | --fault answer_altered|state_unchanged]

In one process (set-up once, the program's graphs kept across seeds):
for each seed, the cell's traffic from that seed, a window of
``--seconds`` (long enough to answer as many worlds as the check samples),
and the reference's judgement of the sample, printed as one JSON line.
``--control tf32`` runs the program with TF32 switched on from the start,
``--control fp8_normals`` / ``bf16_offsets`` with its hyperplane bank one
precision below the configuration's (``control.py``): the controls that
have to come out as not correct.
``--fault answer_altered`` plants a fault instead: each plan's first ``k``
moved where it is produced; ``--fault state_unchanged``: the solver's
step returns its state unchanged (the readings of the numbers the
controls do not move).  The benchmark's own runs never run this.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def readings(name: str, seeds, seconds: float, control: str | None = None, device=None,
             overrides: dict | None = None, emit=None, fault: str | None = None) -> list:
    """One dict per seed: the check's numbers, whether they pass the cell's
    limits, the plans of the window and its seconds."""
    import torch

    import armour_tpu_torch  # noqa: F401  (its import turns TF32 off: before the control's switch)
    from armour_bench import harness
    from armour_bench.control import CONTROLS, answer_altered, state_unchanged

    out = []
    ctx = CONTROLS[control](device or "cuda") if control else contextlib.nullcontext()
    planted = (answer_altered(harness.load_cell(name).workload["entry"]) if fault == "answer_altered"
               else state_unchanged() if fault == "state_unchanged" else contextlib.nullcontext())
    with ctx, planted:
        cell, planner, batch, dev = harness.open_cell(name, device, overrides)
        limits = cell.workload["check"]["limits"]
        for seed in seeds:
            t0 = time.perf_counter()
            pool, entry = harness.start_traffic(cell, planner, batch, seed)
            window = harness.timed_window(entry, seconds, cell.workload["warmup_batches"])
            numbers = harness.check(cell, pool, entry, window, seed, dev)
            row = {"workload": name, "seed": seed, "control": control, "fault": fault,
                   "tf32": torch.backends.cuda.matmul.allow_tf32,
                   "correct": harness.verdict(numbers, limits)[0],
                   "calls": len(window["calls"]), "window_s": window["t_end"] - window["t_start"],
                   "seconds": time.perf_counter() - t0, **numbers}
            out.append(row)
            if emit:
                emit(row)
            del pool, entry, window
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=("tf32", "fp8_normals", "bf16_offsets"), default=None)
    ap.add_argument("--fault", choices=("answer_altered", "state_unchanged"), default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.seconds, args.control,
             emit=lambda row: print(json.dumps(row), flush=True), fault=args.fault)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
