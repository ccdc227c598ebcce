"""safe_plans_per_s: plans returned feasible in the window over the
window's length (host clock, from its start to the return of its last
call, which read its result back).  An infeasible plan is an answer (the
arm brakes) and earns nothing here."""


def read(record):
    seconds = record["t_end"] - record["t_start"]
    return sum(c["feasible"] for c in record["calls"]) / seconds
