"""Verbosity-controlled progress sink for the round drivers, port of
``repro.telemetry.sink`` (the output is the reference's, byte for byte).

Modes:

- ``quiet``      — nothing (the default when ``verbose=False``);
- ``human``      — the one-line-a-report format that ``verbose=True``
  prints;
- ``structured`` — one JSON object a report line (the ledger's field
  names, without the taps).

Drivers resolve the mode with :meth:`ProgressSink.for_run`: an explicit
``TelemetryConfig.verbosity`` wins; ``"auto"`` (or no telemetry at all)
follows the driver's ``verbose`` flag.
"""
from __future__ import annotations

import json
import sys
from typing import Optional


class ProgressSink:
    def __init__(self, mode: str = "quiet", stream=None):
        if mode not in ("quiet", "human", "structured"):
            raise ValueError(f"ProgressSink mode must be quiet, human or "
                             f"structured, got {mode!r}")
        self.mode = mode
        self.stream = stream if stream is not None else sys.stdout

    @classmethod
    def for_run(cls, telemetry, verbose: bool, stream=None) -> "ProgressSink":
        """Resolve the mode from (TelemetryConfig | None, verbose flag)."""
        mode = "human" if verbose else "quiet"
        if telemetry is not None and telemetry.verbosity != "auto":
            mode = telemetry.verbosity
        return cls(mode, stream=stream)

    @property
    def enabled(self) -> bool:
        return self.mode != "quiet"

    # ------------------------------------------------------------------
    def round(self, t: int, loss: float,
              test_error: Optional[float] = None,
              uplink_bytes: Optional[float] = None) -> None:
        """One progress report. ``test_error`` set => the eval-line format
        (always reported); plain rounds are reported at the driver's own
        cadence (every 10th round in the host driver, each block's last
        round in the engine)."""
        if self.mode == "quiet":
            return
        if self.mode == "structured":
            rec = {"kind": "progress", "round": int(t), "loss": float(loss)}
            if test_error is not None:
                rec["test_error"] = float(test_error)
            if uplink_bytes is not None:
                rec["uplink_bytes"] = float(uplink_bytes)
            print(json.dumps(rec), file=self.stream)
            return
        if test_error is not None:
            print(f"round {t:4d} loss {loss:.4f} "
                  f"test_err {test_error:.4f} "
                  f"uplink {uplink_bytes / 1e6:.1f}MB", file=self.stream)
        else:
            print(f"round {t:4d} loss {loss:.4f}", file=self.stream)
