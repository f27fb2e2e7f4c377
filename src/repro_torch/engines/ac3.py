"""AC3 engine — the sequential host baseline (paper §5.1) behind the Engine
protocol; the counterpart of `repro.engines.ac3`. ``prepare`` copies the
constraint tensors to numpy and builds the adjacency lists once;
``count_unit`` is "revisions" (paper Table 1 #Revision), which `SearchStats`
files separately from the tensor engines' recurrences. It computes on the
host whatever ``device`` it is given; results are numpy arrays.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import ac3 as _ac3
from repro_torch.core.csp import CSP
from repro_torch.core.engine import Engine, PreparedNetwork
from repro_torch.core.rtac import EnforceResult
from repro_torch.device import to_numpy
from . import register


@register
class AC3Engine(Engine):
    name = "ac3"
    count_unit = "revisions"
    # sequential baseline: a "batch" is just a host loop, so eager frontier
    # batching in search would waste work — enforce children lazily instead
    supports_batch = False
    # every speculative row is a full host enforcement — keep duplication low
    speculative_rows_hint = 8

    def _prepare_payload(self, csp: CSP):
        cons = to_numpy(csp.cons)
        mask = to_numpy(csp.mask)
        return cons, mask, _ac3.build_neighbours(mask)

    def enforce(self, prepared: PreparedNetwork, dom, changed0=None) -> EnforceResult:
        cons, mask, neighbours = prepared.payload
        if changed0 is not None:
            changed0 = np.asarray(to_numpy(changed0), dtype=bool)
        res = _ac3.enforce_ac3(cons, mask, to_numpy(dom), changed0, neighbours=neighbours)
        # n_recurrences carries this engine's native unit: revisions.
        return EnforceResult(res.dom, res.consistent, res.n_revisions)

    # enforce_batch / enforce_many: the generic host-loop fallbacks in Engine
    # are the right (only) semantics for a sequential baseline.
