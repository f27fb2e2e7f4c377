"""The device's idle share of the traced slice: 100 - the union of its
kernel and copy intervals over the slice, from the profiler."""

from rtacbench.lib.trace import idle_pct


def read(rec):
    return idle_pct(rec)
