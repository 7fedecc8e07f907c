"""The traced run's device trace and host spans.

``torch.profiler`` records the card's activity only (CUDA kernels, copies
and sets): recording the host's ops too costs more than the work on a
host-paced round. The trace stays in memory; the records are read from the
profiler's own results, without building its per-op tables.

Host spans are the harness's own, around its calls into the program (a
block of rounds, the evaluation), on the same wall clock as the profiler's
records, so an idle gap on the card can be named by what the host was in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class Trace:
    kernels: list        # (name, start_ns, end_ns) of each kernel
    copies: list         # (name, start_ns, end_ns) of each copy or set
    spans: list          # (name, start_ns, end_ns) of the harness's calls
    start_ns: int
    end_ns: int
    read_s: float = 0.0  # seconds the profiler's records took to read

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of every kernel's and copy's interval, in order."""
        merged: list = []
        for s, e in sorted((s, e) for _, s, e in self.kernels + self.copies):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, patterns: list) -> tuple[float, int]:
        """Total seconds and count of the kernels a pattern finds."""
        hits = [(s, e) for name, s, e in self.kernels
                if any(p.search(name) for p in patterns)]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def top_kernels(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.kernels + self.copies:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the card, each named by
        the harness span the host was in and the kernel that ended it."""
        busy = self.busy_intervals()
        gaps = [(self.start_ns, busy[0][0])] if busy else []
        gaps += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            gaps.append((busy[-1][1], self.end_ns))
        starts = {s: name for name, s, _ in self.kernels + self.copies}
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            span = next((name for name, a, b in self.spans if a <= s < b),
                        "between calls")
            nxt = starts.get(e, "the window's end")
            out.append([f"{span}, before {nxt[:80]}", (e - s) / 1e9])
        return out


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


def _ns(event, what: str) -> int:
    """A kineto record's time in ns (``start_ns``), or from the older
    microsecond accessor (``start_us``) where the installed torch has only
    that."""
    ns = getattr(event, f"{what}_ns", None)
    if ns is not None:
        return int(ns())
    return int(getattr(event, f"{what}_us")() * 1000)


def _read(prof, start_ns: int, end_ns: int, spans: list) -> Trace:
    kernels, copies = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        name = ev.name()
        (copies if name.startswith(("Memcpy", "Memset")) else
         kernels).append((name, s, e))
    return Trace(kernels, copies, spans, start_ns, end_ns)


@contextlib.contextmanager
def device_trace(enabled: bool, recorder: Recorder, out: list):
    """Profile the card's activity over the block when ``enabled``; the
    :class:`Trace` is appended to ``out`` once the block has synchronised."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.time_ns()
        yield
        torch.cuda.synchronize()
        end = time.time_ns()
    read = time.perf_counter()
    out.append(_read(prof, start, end, recorder.spans))
    out[-1].read_s = time.perf_counter() - read
