"""``syncs_per_round``: the port's blocking device-to-host reads over its
search-driver rounds (the search driver, `core/search.py`), both counted by
the port's always-on registry: ``sync.count`` (`repro_torch.obs.sync_wait`:
a round's metadata, a fixpoint's loop predicate, a host store's read-back,
a closure's extraction) over ``driver.rounds``. Counted from this module's
loading, which comes before set-up, to the reading: set-up's warm-up call
and every call of the window, traced or not (a count does not depend on the
profiler). A program without ``sync.count`` gives nothing."""

from repro_torch.obs import REGISTRY

NAMES = ("sync.count", "driver.rounds")
START = {name: REGISTRY.counter(name) for name in NAMES}


def read(rec):
    syncs, rounds = (REGISTRY.counter(name) - START[name] for name in NAMES)
    if not syncs or not rounds:
        return None
    return syncs / rounds
