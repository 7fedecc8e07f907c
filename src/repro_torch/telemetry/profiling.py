"""Profiling hooks: program spans, trace windows, system sampling, port of
``repro.telemetry.profiling``.

- **program spans** — :func:`span` and :func:`recording`. ``with
  span(name):`` marks where the engine, the round and the local update
  enqueue their work (the names are listed in PERF.md). Off, which is
  the default, a span is one module-level check and a shared no-op
  object: no clock read, no allocation, no device work. Inside ``with
  recording() as spans:`` each span appends ``(path, start_ns, end_ns,
  thread_id)`` to ``spans`` as it closes; ``path`` joins the names of the
  spans open on that thread with ``/``. The stamps are ``time.time_ns()``,
  the wall clock of ``torch.profiler``'s records, so a profile of the
  card can give each kernel to the span that launched it. A span never
  synchronises the device or reads a tensor, so it times the host's
  enqueue, not the device's work.
- :class:`ProfileWindow` — a ``torch.profiler`` trace over an absolute
  round range (``TelemetryConfig.profile_rounds``), written as one Chrome
  trace file a window. The host driver opens and closes it exactly at the
  window's bounds; the engine snaps it outward to eval-block bounds (a
  block is enqueued as a whole). Profiler failures give a one-time
  warning: tracing is observability, never a dependency of the rounds.
- :func:`device_memory_peak` — the peak bytes the caching allocator has
  handed out on a CUDA device since the process started (or the last
  ``torch.cuda.reset_peak_memory_stats``), as the reference's
  ``peak_bytes_in_use``; ``None`` on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Optional

import torch

# ----------------------------------------------------------------------
# Program spans
# ----------------------------------------------------------------------
_SPANS: Optional[list] = None     # the open recording's list; None = off
_OPEN = threading.local()         # .names: the spans open on this thread
_NO_SPAN = contextlib.nullcontext()   # every span while the recorder is off


class _Span:
    __slots__ = ("name", "out", "path", "start")

    def __init__(self, name: str, out: list):
        self.name, self.out = name, out

    def __enter__(self):
        names = getattr(_OPEN, "names", None)
        if names is None:
            names = _OPEN.names = []
        names.append(self.name)
        self.path = "/".join(names)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.names.pop()
        self.out.append((self.path, self.start, end, threading.get_ident()))
        return False


def span(name: str):
    """A context manager over the host's enqueue of one piece of work:
    recorded inside :func:`recording`, the shared no-op otherwise."""
    if _SPANS is None:
        return _NO_SPAN
    return _Span(name, _SPANS)


@contextlib.contextmanager
def recording():
    """Record every span that opens in the block, on every thread; yields
    the list the spans append to. A span open when the block ends still
    lands in the list as it closes. Recordings do not nest."""
    global _SPANS
    if _SPANS is not None:
        raise RuntimeError("a span recording is already open")
    out: list = []
    _SPANS = out
    try:
        yield out
    finally:
        _SPANS = None


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
