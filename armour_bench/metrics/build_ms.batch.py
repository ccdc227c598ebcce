"""build_ms.batch: ms from a batched plan's call to the program's "built"
mark (``ArmourPlanner.run_program(marks=)``: host clock after a device
synchronise), the mean over the traced run's marked calls."""


def read(record):
    ms = [m["built"] - m["start"] for m in record["marks"] if "built" in m]
    return 1e3 * sum(ms) / len(ms) if ms else None
