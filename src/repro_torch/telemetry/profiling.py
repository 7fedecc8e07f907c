"""Profiling hooks: trace windows, engine-cache counters, system sampling,
port of ``repro.telemetry.profiling``.

- :class:`ProfileWindow` — a ``torch.profiler`` trace over an absolute
  round range (``TelemetryConfig.profile_rounds``), written as one Chrome
  trace file a window. The host driver opens and closes it exactly at the
  window's bounds; the engine snaps it outward to eval-block bounds (a
  block is enqueued as a whole). Profiler failures give a one-time
  warning: tracing is observability, never a dependency of the rounds.
- **engine-cache counters** — :func:`note_engine_cache`,
  :func:`engine_cache_stats`. The reference counts the builds and hits of
  its compiled-callable cache. The port has no such cache yet (it waits
  for CUDA graphs of a round, ROADMAP): each ``run_training`` call builds
  its round function once (``round_builds``) and each
  ``run_training_scan`` call its block function once (``block_builds``),
  and nothing is ever a hit (no ``*_hits`` key appears).
- :func:`device_memory_peak` — the peak bytes the caching allocator has
  handed out on a CUDA device since the process started (or the last
  ``torch.cuda.reset_peak_memory_stats``), as the reference's
  ``peak_bytes_in_use``; ``None`` on the CPU.
"""
from __future__ import annotations

import collections
import os
import sys
from typing import Optional

import torch

# ----------------------------------------------------------------------
# Engine-cache counters
# ----------------------------------------------------------------------
_CACHE_EVENTS: "collections.Counter[str]" = collections.Counter()


def note_engine_cache(kind: str, *, hit: bool) -> None:
    """Record one build (``hit=False``) or reuse of an engine function:
    ``kind`` is ``"round"`` (the host driver's round function) or
    ``"block"`` (the engine's block function)."""
    _CACHE_EVENTS[f"{kind}_{'hits' if hit else 'builds'}"] += 1


def engine_cache_stats() -> dict:
    """Cumulative ``<kind>_builds`` / ``<kind>_hits`` counts since the
    last reset."""
    return dict(_CACHE_EVENTS)


def reset_engine_cache_stats() -> None:
    _CACHE_EVENTS.clear()


# ----------------------------------------------------------------------
# System sampling
# ----------------------------------------------------------------------
def device_memory_peak(device) -> Optional[int]:
    """``torch.cuda.max_memory_allocated(device)`` on a CUDA device, else
    ``None``."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


# ----------------------------------------------------------------------
# torch.profiler trace windows
# ----------------------------------------------------------------------
class ProfileWindow:
    """Start/stop a ``torch.profiler`` trace over a round range.

    Host driver: ``round_begin(t)`` / ``round_end(t)`` bracket each round:
    the trace starts when ``t`` reaches the window's first round and stops
    after its last. Engine: ``block_begin(t0, t1)`` / ``block_end(t1)``
    bracket each eval block of absolute rounds ``[t0, t1)``: the trace
    covers every block that overlaps the window.

    The trace records the host's ops and, on a CUDA device, the card's
    kernels. At stop the device is synchronised (the rounds' kernels run
    after the host enqueues them) and the trace is written to
    ``<trace_dir>/rounds_<first>-<last>.json``, the rounds it covers.
    """

    def __init__(self, rounds: Optional[tuple[int, int]], trace_dir: str,
                 device="cuda"):
        self.lo, self.hi = rounds if rounds is not None else (None, None)
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.active = False
        self._prof = None
        self._span = None
        self._warned = False

    @classmethod
    def from_config(cls, telemetry, device="cuda") -> "ProfileWindow":
        if telemetry is None:
            return cls(None, "", device)
        return cls(telemetry.profile_rounds, telemetry.profile_dir, device)

    # ------------------------------------------------------------------
    def _warn(self, what: str, e: Exception) -> None:
        if not self._warned:
            print(f"telemetry: profiler {what} ({e})", file=sys.stderr)
            self._warned = True

    def _start(self, first: int) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self.active = True
            self._span = [first, first]
        except Exception as e:   # profiling is best-effort
            self._warn("trace unavailable", e)
            self.lo = None       # don't retry every round

    def _stop(self) -> None:
        if not self.active:
            return
        self.active = False
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir,
                                "rounds_{}-{}.json".format(*self._span))
            self._prof.export_chrome_trace(path)
        except Exception as e:
            self._warn("stop failed", e)
        self._prof = None

    # ---- host driver: exact round bounds ----
    def round_begin(self, t: int) -> None:
        if self.lo is not None and not self.active and self.lo <= t <= self.hi:
            self._start(t)

    def round_end(self, t: int) -> None:
        if self.active:
            self._span[1] = t
            if t >= self.hi:
                self._stop()

    # ---- engine: eval-block granularity ----
    def block_begin(self, t0: int, t1: int) -> None:
        """Block covers absolute rounds [t0, t1)."""
        if self.lo is not None and not self.active and \
                t0 <= self.hi and t1 > self.lo:
            self._start(t0)

    def block_end(self, t1: int) -> None:
        if self.active:
            self._span[1] = t1 - 1
            if t1 > self.hi:
                self._stop()

    def close(self) -> None:
        """Stop an open trace at the end of a run (the window reaches past
        the last round)."""
        self._stop()
