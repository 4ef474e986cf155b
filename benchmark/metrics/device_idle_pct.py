"""device_idle_pct.<run|genome>: the share of the traced window in which no
device operation runs (the union of the profiler's intervals taken away),
in %."""

from metrics._common import device_idle_pct


def read(data):
    return device_idle_pct(data)
