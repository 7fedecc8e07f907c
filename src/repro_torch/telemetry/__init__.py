"""Round telemetry, port of ``repro.telemetry``: taps, the JSONL ledger,
the progress sink and profiling through ``torch.profiler``.

The ledger's schema is the reference's (``LEDGER_SCHEMA = 1``), so a ledger
written by either package reads and renders the same in both. The round
builders import :mod:`repro_torch.telemetry.taps` and the drivers
:mod:`repro_torch.telemetry.profiling` directly. The mesh half (client
partials reduced across a mesh, the aggregation tiers) waits for the
mesh slice (ROADMAP Queue 1, item 11).
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
