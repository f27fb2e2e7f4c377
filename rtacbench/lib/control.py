"""The control: the plain reference put in the program's place, with one of
the configuration's guarantees broken.

The configurations state no precision, so the control breaks a guarantee
instead: every enforcement returns the arc-consistency closure. The control
stops each fixpoint after `STEPS` recurrence (forward checking, not arc
consistency). A comparison that does not come out false on it cannot tell a
closure from a cheaper approximation, and would let one through.
"""

from __future__ import annotations

import torch

from rtacbench.reference import fixpoint as fx
from rtacbench.reference import mac

#: recurrences the control's fixpoints stop after
STEPS = 1


def solve(cons, mask, dom, max_assignments) -> mac.Record:
    """The control's MAC search on a CSP as the program was handed it."""
    return mac.solve(fx.dense_network(cons.cpu(), mask.cpu()), dom.cpu(), max_assignments,
                     max_steps=STEPS)


def enforce_batch(net: fx.Network, doms: torch.Tensor, seed: torch.Tensor) -> fx.Closure:
    """The control's fixpoints over a batch (bitset domains)."""
    return fx.fixpoint(net, doms, seed, max_steps=STEPS)
