"""``round_ms``: the window's wall time over its lockstep rounds (the search
driver, `core/search.py`). A round is one dispatch of every live search's
pending request; `solve_many`'s telemetry counts them, and `mac_solve`'s
`SearchStats.rounds`. Calls under the profiler are left out: it slows
the host."""


def read(rec):
    c = rec["counts"]
    if not c.get("rounds"):
        return None
    return 1e3 * c["untraced_s"] / c["rounds"]
