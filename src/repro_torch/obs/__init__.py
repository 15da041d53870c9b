"""Observability across every runtime: phase spans, invariant probes and
the run ledger (port of `repro.obs`, the same exported names).

  telemetry  the `Telemetry` event sink: per-round / per-phase spans
             (named after `core.engine.make_phases`), counters (wire
             bytes, active-set sizes, peak memory) and sampled probes;
             off by default (`telemetry=None` runs the code without the
             sink, and a sink changes no iterate: tests/test_torch_obs.py)
  probes     pure invariant probes: the GT residual `||sum_i c_i||`,
             tracker-table against `SparseTracker` drift, EF residual
             norms, priced against measured bytes, the duality gap
  ledger     the structured export: a JSONL event stream and the run
             manifest (resolved config, strategy knob signature, seed
             folds, schedule digest)
  memory     `peak_memory` (`benchmarks.common` re-exports it)

The overhead gate lives in `benchmarks/obs.py`: telemetry enabled without
probes must stay within 3% of disabled wall clock.
"""
from . import probes
from .ledger import RunLedger, run_manifest
from .memory import peak_memory
from .telemetry import Telemetry, maybe_span

__all__ = [
    "RunLedger",
    "Telemetry",
    "maybe_span",
    "peak_memory",
    "probes",
    "run_manifest",
]
