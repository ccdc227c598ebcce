"""solve_ms.batch: ms from the program's "built" mark to its "solved"
mark (the solve and the verification), the mean over the traced run's
marked calls."""


def read(record):
    ms = [m["solved"] - m["built"] for m in record["marks"] if "solved" in m and "built" in m]
    return 1e3 * sum(ms) / len(ms) if ms else None
