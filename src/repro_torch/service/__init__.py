"""repro_torch.service — continuous-batching solver service, the PyTorch
counterpart of `repro.service`.

    from repro_torch.service import SolverService

    svc = SolverService(engine="hopper_packed", device="cuda")
    req = svc.submit(csp, deadline_s=1.0)        # futures-style handle
    solution, stats = req.result()               # drives the event loop

Requests arriving over time are routed to shape buckets, their constraint
networks deduplicated through a byte-budgeted prepared-network cache, and all
live searches in a bucket advance through ONE lockstep dispatch per round —
new admissions join mid-flight, finished searches free their rows mid-flight.
`repro_torch.launch.serve` replays seeded Poisson arrival traces against it.
On the Hopper engines every round runs the CUDA kernels in place on the
bucket's slot tables (each row's network read through its slot id).

The request path is hardened end-to-end: seeded fault injection
(`repro_torch.faults`), retry + engine-fallback ladders, per-round watchdogs
with bucket circuit breakers, and typed `Overloaded` load shedding.
"""

from .buckets import Bucket, bucket_for, pad_csp
from .cache import CacheEntry, PreparedNetworkCache, network_fingerprint
from .metrics import ServiceMetrics
from .service import InvalidRequest, RequestStatus, SolveRequest, SolverService
from .trace import (
    DEFAULT_VARIANTS,
    FastForwardClock,
    TraceEvent,
    dedup_trace,
    poisson_trace,
    replay,
    replay_rate_cell,
)

__all__ = [
    "Bucket",
    "bucket_for",
    "pad_csp",
    "CacheEntry",
    "PreparedNetworkCache",
    "network_fingerprint",
    "ServiceMetrics",
    "InvalidRequest",
    "RequestStatus",
    "SolveRequest",
    "SolverService",
    "DEFAULT_VARIANTS",
    "FastForwardClock",
    "TraceEvent",
    "dedup_trace",
    "poisson_trace",
    "replay",
    "replay_rate_cell",
]
