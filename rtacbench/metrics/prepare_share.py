"""``prepare_share``: the share of the untraced `solve_many` calls' wall
time spent preparing them (the search driver, `core/search.py`): 100 x
their ``prepare_seconds`` (the ``search.prepare`` span: each instance built
and written into its slot, the frontier, the admissions) over their wall.
A program whose telemetry lacks ``prepare_seconds`` gives nothing."""


def read(rec):
    c = rec["counts"]
    if not c.get("untraced_s") or "prepare_seconds" not in c:
        return None
    return 100.0 * c["prepare_seconds"] / c["untraced_s"]
