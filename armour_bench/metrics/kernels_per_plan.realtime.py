"""kernels_per_plan.realtime: device kernels (memory copies and sets left
out) in the profiled sub-window per plan call."""

from armour_bench.trace import kernels_per_call


def read(record):
    return kernels_per_call(record["profile"])
