"""``svc_rows_per_round``: frontier rows a service round dispatched
(`service/`): `ServiceMetrics` rows dispatched over rounds, from the
window's start to the end of the drain."""


def read(rec):
    c = rec["counts"]
    if not c.get("svc_rounds"):
        return None
    return c["svc_rows"] / c["svc_rounds"]
