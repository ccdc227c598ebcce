"""setup_s: seconds from the start of the run's process to the end of the
warm-up (imports, the kernels' build or load, the planner, the traffic
pool, one first call per shape the traffic uses, then the traffic until
the cell's warm-up time has passed and the pace of its calls has turned)."""


def read(record):
    return record["setup_s"]
