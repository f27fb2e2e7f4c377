"""``upload_ms``: device time of the host-to-device copies per traced
``enforce_batch`` call (the batch's upload: `core/rtac.py`,
`engines/hopper.py`), from the profiler."""

from rtacbench.lib.trace import seconds_of


def read(rec):
    t = rec["trace"]
    if t is None or not t["units"]:
        return None
    s = seconds_of(t, "Memcpy HtoD")
    return None if s is None else 1e3 * s / t["units"]
