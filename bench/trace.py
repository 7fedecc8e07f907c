"""The traced run's device trace, host spans and the program's spans.

``torch.profiler`` records the card's activity only (CUDA kernels, copies
and sets): recording the host's ops too costs more than the work on a
host-paced round. The trace stays in memory; the records are read once
from the profiler's own results (:func:`bench.spans.read_launches`),
without building its per-op tables, each with the time the host launched
it.

Host spans are the harness's own, around its calls into the program (a
block of rounds, the evaluation). The program's spans
(``repro_torch.telemetry.profiling.recording()``, open over the traced
window only) mark its engine, rounds, local update and kernels' callers.
Both are on the wall clock of the profiler's records, so each piece of
work is given to the span that launched it (:mod:`bench.spans`) and an
idle gap on the card is named by what the host was in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import torch

from bench import spans as spans_mod


@dataclasses.dataclass
class Trace:
    kernels: list        # (name, start_ns, end_ns[, launch_ns]) of each kernel
    copies: list         # the same of each copy or set
    spans: list          # (name, start_ns, end_ns) of the harness's calls
    start_ns: int
    end_ns: int
    read_s: float = 0.0  # seconds the profiler's records took to read
    # (path, start_ns, end_ns, thread) of the program's spans
    program: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of every kernel's and copy's interval, in order."""
        merged: list = []
        for s, e in sorted((r[1], r[2]) for r in self.kernels + self.copies):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, patterns: list) -> tuple[float, int]:
        """Total seconds and count of the kernels a pattern finds."""
        hits = [(r[1], r[2]) for r in self.kernels
                if any(p.search(r[0]) for p in patterns)]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def top_kernels(self, n: int = 10) -> list:
        by: dict = {}
        for r in self.kernels + self.copies:
            by[r[0]] = by.get(r[0], 0) + (r[2] - r[1])
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    @functools.cached_property
    def attribution(self) -> Optional[tuple[dict, spans_mod.Timeline]]:
        """``(by_span table, timeline)`` of the program's spans
        (:func:`bench.spans.attribute`), worked out once for every reader;
        ``None`` without program spans or launch times."""
        return spans_mod.attribute(
            spans_mod.Launches(self.kernels, self.copies), self.spans,
            self.program)

    @property
    def by_span(self) -> Optional[dict]:
        """``{path: [device_s, host_s, calls]}``, or ``None``."""
        return self.attribution[0] if self.attribution else None

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the card, each named by
        the innermost span (program or harness) open at its start, with
        its parent, and the work that ended it
        (:func:`bench.spans.idle_gaps`)."""
        timeline = (self.attribution[1] if self.attribution
                    else spans_mod.Timeline(self.spans, self.program))
        return spans_mod.idle_gaps(
            self.busy_intervals(), spans_mod.Launches(self.kernels,
                                                      self.copies),
            timeline, self.start_ns, self.end_ns, n, depth=2)


class Recorder:
    """Host spans of the harness's calls, on the profiler's clock."""

    def __init__(self):
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))


@contextlib.contextmanager
def device_trace(enabled: bool, recorder: Recorder, out: list):
    """Profile the card's activity over the block, and record the
    program's spans, when ``enabled``; the :class:`Trace` is appended to
    ``out`` once the block has synchronised."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry import profiling
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as program:
            torch.cuda.synchronize()
            start = time.time_ns()
            yield
            torch.cuda.synchronize()
            end = time.time_ns()
    read = time.perf_counter()
    launches = spans_mod.read_launches(prof)
    out.append(Trace(launches.kernels, launches.copies, recorder.spans,
                     start, end, program=list(program)))
    out[-1].read_s = time.perf_counter() - read
