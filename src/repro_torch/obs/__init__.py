"""`repro_torch.obs` — spans and the always-on metric registry.

The PyTorch counterpart of `repro.obs`:

- **tracer** (`obs.span` / `obs.fence`, `obs.tracing`): nested wall-clock
  spans in a bounded ring. OFF by default — zero overhead — enabled by
  `enable()` or ``REPRO_TORCH_TRACE=1``; ``timing="fenced"`` makes `fence`
  call ``torch.cuda.synchronize()`` so spans measure device completion
  instead of the asynchronous launch. While on, the tracer keeps each span
  name's count and seconds (`Tracer.snapshot_totals`), and a span opened
  under a recording `torch.profiler` is mirrored into its trace as a
  ``record_function`` of the same name, on the clock of the kernels. The
  span names and what each brackets are listed in `obs.tracing`.
- **syncs** (`obs.sync_wait`): every blocking device→host read of the
  search and fixpoint paths counts ``sync.count`` (always on) and, tracing
  on, is a ``sync.wait`` span.
- **registry** (`obs.REGISTRY`, `obs.counter_add` / `gauge_set` /
  `observe`): named counters/gauges/histograms every subsystem publishes
  into; `snapshot()` is one ``repro-obs/v1`` dict.
- **export** (`obs.dump_run` / `write_trace`, ``python -m repro_torch.obs``):
  run dumps and Chrome-trace/Perfetto timelines.
"""

from . import export, registry, tracing  # noqa: F401  (submodule access)
from .export import child_coverage, chrome_trace, dump_run, load_run, run_payload, write_trace
from .registry import (
    REGISTRY,
    SCHEMA,
    Registry,
    RegistryScope,
    counter_add,
    gauge_set,
    mean,
    observe,
    percentile,
    snapshot,
    summarize,
)
from .tracing import (
    Span,
    Tracer,
    disable,
    enable,
    enable_from_env,
    enabled,
    fence,
    fencing,
    get_tracer,
    now,
    record_complete,
    span,
    sync_wait,
)

__all__ = [
    "REGISTRY", "SCHEMA", "Registry", "RegistryScope", "Span", "Tracer",
    "child_coverage", "chrome_trace", "counter_add", "disable", "dump_run",
    "enable", "enable_from_env", "enabled", "fence", "fencing", "gauge_set",
    "get_tracer", "load_run", "mean", "now", "observe", "percentile",
    "record_complete", "run_payload", "snapshot", "span", "summarize",
    "sync_wait", "write_trace",
]

# honour REPRO_TORCH_TRACE=1 at first import, wherever that import happens
enable_from_env()
