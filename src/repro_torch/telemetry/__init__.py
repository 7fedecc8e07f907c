"""Round telemetry, port of ``repro.telemetry``: taps, the JSONL ledger,
the progress sink and profiling through ``torch.profiler``.

The ledger's schema is the reference's (``LEDGER_SCHEMA = 1``), so a ledger
written by either package reads and renders the same in both. The round
builders import :mod:`repro_torch.telemetry.taps` and the drivers
:mod:`repro_torch.telemetry.profiling` directly. On a client mesh the
taps' client-row partials ride the round's one cross-rank sum
(``taps.collect(client_sq=)``), the comm record carries the aggregation
tiers' bytes (``agg_*``), the run header the mesh, its tiers and the
sample sharding, and rank 0 alone writes the ledger, prints and profiles.
"""
from repro_torch.telemetry.config import TelemetryConfig, VERBOSITY_MODES
from repro_torch.telemetry.ledger import (
    LEDGER_SCHEMA,
    RoundLedger,
    read_ledger,
    split_runs,
)
from repro_torch.telemetry.sink import ProgressSink

__all__ = [
    "TelemetryConfig",
    "VERBOSITY_MODES",
    "LEDGER_SCHEMA",
    "RoundLedger",
    "read_ledger",
    "split_runs",
    "ProgressSink",
]
