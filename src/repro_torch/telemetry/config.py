"""Telemetry configuration: what the round drivers tap, log and profile,
port of ``repro.telemetry.config``.

``FLConfig(telemetry=TelemetryConfig(...))`` switches the round drivers
from their default metrics into structured observability:

- **metric taps** (``taps=True``) widen the per-round metrics dict with
  per-layer divergence vectors (the Eq. 4 inputs), per-layer selection
  counts, per-client selection masks (``full_selection``) and
  strategy-state summaries (FedLAMA's interval/ttl vectors, EF residual
  norms), all built from device tensors: the engine stacks them over a
  block and pulls them with the block's losses, with **no host sync while
  a block enqueues**;
- a **JSONL event ledger** (``ledger_path``): one schema-versioned record
  a round (plus run-header and eval records), written by both drivers and
  opened in append mode, so a run resumed through
  ``start_round``/``server_state`` continues a contiguous ledger;
- **profiling hooks**: a ``torch.profiler`` trace window over a round
  range (``profile_rounds``) and per-round wall-clock and peak device
  memory (``sample_system``);
- a **verbosity-controlled progress sink** (``verbosity``): ``quiet`` /
  ``human`` (the one-line-per-eval format of ``verbose=True``) /
  ``structured`` (JSON lines).

``telemetry=None`` (the FLConfig default) is the zero-cost path: the
rounds and blocks do exactly what they did without this module, and
fixed-seed trajectories are bit-identical with telemetry on (taps only
read).

Trace-relevant fields: the port builds no compiled round (there is no
CUDA graph yet), so "trace-relevant" means the fields that change the
work a round or block enqueues on the device: ``taps`` and
``full_selection``. :meth:`trace_key` keeps those and resets the
host-only ones, as the reference's engine cache keys on it. The config
stays frozen and hashable (``FLConfig`` is).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

VERBOSITY_MODES = ("auto", "quiet", "human", "structured")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Per-run observability knobs (see module docstring)."""

    # ---- taps (trace-relevant: change the work a round enqueues) ----
    taps: bool = True            # per-layer divergence/selection/state taps
    full_selection: bool = True  # include the full (K, U) selection mask
    # ---- host-side event ledger ----
    ledger_path: Optional[str] = None   # JSONL sink; None = no ledger
    run_id: str = ""                    # free-form run label in the header
    # ---- progress sink ----
    # "auto" follows the driver's ``verbose`` flag (human when verbose);
    # "quiet"/"human"/"structured" force a mode regardless of ``verbose``.
    verbosity: str = "auto"
    # ---- profiling hooks ----
    # (start, stop) absolute round indices for a torch.profiler trace
    # window (inclusive; the engine snaps the window to eval-block bounds).
    profile_rounds: Optional[tuple[int, int]] = None
    profile_dir: str = "telemetry_trace"
    # per-round wall-clock + peak-device-memory sampling (ledger fields;
    # the engine takes one sample an eval block)
    sample_system: bool = True

    def __post_init__(self):
        if self.verbosity not in VERBOSITY_MODES:
            raise ValueError(
                f"verbosity must be one of {VERBOSITY_MODES}, "
                f"got {self.verbosity!r}")
        if self.profile_rounds is not None:
            lo, hi = self.profile_rounds
            if lo > hi or lo < 0:
                raise ValueError(
                    f"profile_rounds must be (start <= stop), 0-based "
                    f"absolute round indices; got {self.profile_rounds}")
            # a tuple of ints keeps the config hashable and comparable
            object.__setattr__(self, "profile_rounds", (int(lo), int(hi)))

    # ------------------------------------------------------------------
    def trace_key(self) -> "TelemetryConfig":
        """The trace-relevant subset (see module docstring): ``taps`` and
        ``full_selection``; the host-only fields (ledger path, run id,
        verbosity, profiler window, system sampling) are reset."""
        return TelemetryConfig(taps=self.taps,
                               full_selection=self.full_selection)

    @property
    def wants_ledger(self) -> bool:
        return bool(self.ledger_path)
