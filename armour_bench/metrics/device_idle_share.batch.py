"""device_idle_share.batch: the share of the profiled sub-window in which
no device activity ran, in %, with the time the profiler's own host work
held the device idle (its buffers, the graph launches it stretches) left
out of the idle time and of the window (``trace.idle_share``)."""

from armour_bench.trace import idle_share


def read(record):
    return idle_share(record["profile"])
