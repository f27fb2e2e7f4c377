"""``gen_late_ms``: the 95th percentile (nearest rank) of how late the
benchmark's open-loop generator submitted each request after it was due,
outside the traced slice (the profiler's start and stop stall the loop). It says
whether the window measured the system or the client."""

import math


def read(rec):
    late = rec["counts"].get("late_ms")
    if not late:
        return None
    ordered = sorted(late)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
