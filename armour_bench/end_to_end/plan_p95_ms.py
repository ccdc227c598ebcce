"""plan_p95_ms: the nearest-rank 95th percentile, in ms, of every call of
the window, each timed on the host from the call to its result read back."""

from armour_bench.harness import percentile


def read(record):
    return 1e3 * percentile([c["t1"] - c["t0"] for c in record["calls"]], 95.0)
