"""``pad_share``: the share of the rows a frontier dispatched that were
padding (`core/engine.py` `FrontierTable`): 100 x (1 - rows dispatched /
rows padded), from `solve_many`'s telemetry over the window."""


def read(rec):
    c = rec["counts"]
    if not c.get("rows_padded"):
        return None
    return 100.0 * (1.0 - c["rows_dispatched"] / c["rows_padded"])
