"""``wide_revises_per_round``: the single-network revise's wide launches
(`kernels/launch.py` `single_wide`: the block revise's kernel on the whole
network, one a recurrence of the host-loop fixpoint, `core/rtac.py`) over the
search driver's rounds, both counted by the port's always-on registry:
``revise.wide`` over ``driver.rounds``. Counted, as ``syncs_per_round`` is,
from this module's loading, before set-up, to the reading. A program without
``revise.wide`` gives nothing."""

from repro_torch.obs import REGISTRY

NAMES = ("revise.wide", "driver.rounds")
START = {name: REGISTRY.counter(name) for name in NAMES}


def read(rec):
    wide, rounds = (REGISTRY.counter(name) - START[name] for name in NAMES)
    if not wide or not rounds:
        return None
    return wide / rounds
