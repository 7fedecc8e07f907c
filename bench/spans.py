"""The card's work given to the span that launched it.

A profile of the card's activity (``torch.profiler``, CUDA activity only)
holds each kernel and copy the card ran and the host's CUDA API call that
launched it, under one correlation id. The start of that call is the
work's launch time, on the host's wall clock. The program's spans
(``repro_torch.telemetry.profiling.recording()``: ``(path, start_ns,
end_ns, thread_id)``) and the harness's spans (``(name, start_ns,
end_ns)``) are on the same clock, so each launch goes to the innermost span,
over all threads, that is open at its launch time.

A span's full path names every span that encloses it in time, on any
thread: the autograd engine's device thread runs the attention backward
inside the main thread's ``local_update``, which waits on it, so its path
is ``run_training_scan/.../local_update/attention.bwd``. Work launched in
no span goes to ``between calls``.

:func:`by_span` gives ``{path: [device_s, host_s, calls]}``: the device
seconds of the work a path launched itself (not its children's), the host
seconds its spans were open, and how many there were. The per-layer
numbers of the program's layers are sums over that table
(:func:`subtree_device_ms` for a span and everything under it); each is
``None`` where the table holds no span it sums, and the table is ``None``
when the trace has no program spans or no launch times (a program without
the recorder, or a torch whose records lack the correlation). A traced
run of the harness works the table out once (``bench.trace.Trace``) for
every reader in ``bench/metrics/``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import torch

BETWEEN = "between calls"
UNLAUNCHED = "no launch record"


@dataclasses.dataclass
class Launches:
    """The card's work with launch times: ``(name, start_ns, end_ns,
    launch_ns or None)`` of each kernel and of each copy or set."""
    kernels: list
    copies: list

    def all(self) -> list:
        return self.kernels + self.copies

    def stamped(self) -> bool:
        return any(r[3] is not None for r in self.all())


def _clock(cls, what: str):
    """The accessor of a kineto record's time in ns (``start_ns``), or one
    over the older microsecond accessor (``start_us``) where the installed
    torch has only that; looked up once on the record's class."""
    ns = getattr(cls, f"{what}_ns", None)
    if ns is not None:
        return ns
    us = getattr(cls, f"{what}_us")
    return lambda ev: int(us(ev) * 1000)


def read_launches(prof) -> Launches:
    """Every CUDA record of a finished ``torch.profiler.profile``, in one
    pass over its records, with the start of the host call of the same
    correlation id as its launch time. Copies and sets (``Memcpy``,
    ``Memset``) are kept apart from kernels."""
    events = prof.profiler.kineto_results.events()
    if not events:
        return Launches([], [])
    cls = type(events[0])
    start, duration = _clock(cls, "start"), _clock(cls, "duration")
    device_type, corr, name = cls.device_type, cls.correlation_id, cls.name
    cuda = torch.autograd.DeviceType.CUDA
    launched: dict = {}
    device = []
    for ev in events:
        if device_type(ev) == cuda:
            device.append(ev)
            continue
        cid = corr(ev)
        if cid:
            s = start(ev)
            if s < launched.get(cid, s + 1):
                launched[cid] = s
    kernels, copies = [], []
    for ev in device:
        s = start(ev)
        launch = launched.get(corr(ev))
        if launch is None:
            launch = launched.get(ev.linked_correlation_id())
        label = name(ev)
        (copies if label.startswith(("Memcpy", "Memset")) else
         kernels).append((label, s, s + duration(ev), launch))
    return Launches(kernels, copies)


class Timeline:
    """The harness's and the program's spans on one clock: which span is
    the innermost open at a time, and each span's full path."""

    def __init__(self, harness: list, program: list):
        self.harness_names = {name for name, _, _ in harness}
        spans = ([(s, e, name) for name, s, e in harness]
                 + [(s, e, path.rsplit("/", 1)[-1])
                    for path, s, e, _ in program])
        # an enclosing span that opens at the same time opens first
        order = sorted(range(len(spans)),
                       key=lambda i: (spans[i][0], -spans[i][1]))
        events = sorted([(spans[i][0], 1, rank, i)
                         for rank, i in enumerate(order)]
                        + [(spans[i][1], 0, rank, i)
                           for rank, i in enumerate(order)])
        self.spans = spans
        self.paths = [""] * len(spans)
        self.times: list = []
        self.inner: list = []       # the innermost span from times[j] on
        open_: list = []            # (rank, i) of the open spans
        for t, opens, rank, i in events:
            if opens:
                parent = max(open_)[1] if open_ else None
                name = spans[i][2]
                self.paths[i] = (name if parent is None
                                 else f"{self.paths[parent]}/{name}")
                open_.append((rank, i))
            else:
                open_.remove((rank, i))
            inner = max(open_)[1] if open_ else None
            if self.times and self.times[-1] == t:
                self.inner[-1] = inner
            else:
                self.times.append(t)
                self.inner.append(inner)

    def at(self, t: int) -> str:
        """The full path of the innermost span open at ``t``."""
        j = bisect.bisect_right(self.times, t) - 1
        if j < 0 or self.inner[j] is None:
            return BETWEEN
        return self.paths[self.inner[j]]

    def harness_only(self, path: str) -> bool:
        """Whether no program span claims ``path``'s work."""
        last = path.rsplit("/", 1)[-1]
        return last in self.harness_names or last in (BETWEEN, UNLAUNCHED)


def by_span(launches: Launches, timeline: Timeline) -> dict:
    """``{path: [device_s, host_s, calls]}`` (see the module doc)."""
    out: dict = {}

    def row(path):
        return out.setdefault(path, [0.0, 0.0, 0])

    for (s, e, _), path in zip(timeline.spans, timeline.paths):
        r = row(path)
        r[1] += (e - s) / 1e9
        r[2] += 1
    for _, s, e, launch in launches.all():
        path = UNLAUNCHED if launch is None else timeline.at(launch)
        row(path)[0] += (e - s) / 1e9
    return out


def attribute(launches: Launches, harness: list,
              program: list) -> Optional[tuple[dict, Timeline]]:
    """``(by_span table, timeline)``, or ``None`` without program spans or
    launch times."""
    if not program or not launches.stamped():
        return None
    timeline = Timeline(harness, program)
    return by_span(launches, timeline), timeline


# ----------------------------------------------------------------------
# The program's layers, as sums over the table (each a round: ms)
# ----------------------------------------------------------------------
def _parts(path: str) -> list:
    return path.split("/")


def subtree_device_ms(by: dict, rounds: int, name: str) -> Optional[float]:
    """Device ms a round launched under any path that holds the span
    ``name`` (its subtree); ``None`` where no such span opened."""
    rows = [r for p, r in by.items() if name in _parts(p)]
    if not rows:
        return None
    return sum(r[0] for r in rows) / rounds * 1e3


def local_training_ms(by: dict, rounds: int) -> Optional[float]:
    """Device ms a round launched under ``local_update`` (its subtree)."""
    return subtree_device_ms(by, rounds, "local_update")


def server_ms(by: dict, rounds: int) -> Optional[float]:
    """Device ms a round launched under an ``engine.*`` or ``round.*`` span
    but not under ``local_update``; ``None`` where no such span opened."""
    rows = [r for p, r in by.items()
            if "local_update" not in _parts(p)
            and any(x.startswith(("engine.", "round.")) for x in _parts(p))]
    if not rows:
        return None
    return sum(r[0] for r in rows) / rounds * 1e3


def host_enqueue_ms(by: dict, rounds: int) -> Optional[float]:
    """Host ms a round inside ``engine.round`` spans; ``None`` where no
    such span opened."""
    rows = [r for p, r in by.items() if _parts(p)[-1] == "engine.round"]
    if not rows:
        return None
    return sum(r[1] for r in rows) / rounds * 1e3


def attention_bwd_ms(by: dict, rounds: int) -> Optional[float]:
    """Device ms a round launched under ``attention.bwd``; ``None`` where
    no such span opened."""
    return subtree_device_ms(by, rounds, "attention.bwd")


def evaluation_ms(by: dict, rounds: int) -> float:
    """Device ms a round launched inside the harness's ``evaluation``."""
    return sum(r[0] for p, r in by.items()
               if _parts(p)[0] == "evaluation") / rounds * 1e3


def unclaimed_share(by: dict, timeline: Timeline) -> float:
    """The share of the work's device time that no program span and not
    the evaluation claims."""
    total = sum(r[0] for r in by.values())
    loose = sum(r[0] for p, r in by.items()
                if timeline.harness_only(p) and _parts(p)[0] != "evaluation")
    return loose / total if total else 0.0


def _gaps(busy: list, start_ns: int, end_ns: int) -> list:
    gaps = [(start_ns, busy[0][0])] if busy else []
    gaps += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps.append((busy[-1][1], end_ns))
    return gaps


def idle_gaps(busy: list, launches: Launches, timeline: Timeline,
              start_ns: int, end_ns: int, n: int = 10,
              depth: Optional[int] = None) -> list:
    """The longest stretches with nothing on the card (``busy`` is the
    union of the work's intervals), each named by the innermost span open
    at its start (the last ``depth`` names of its path, or all of them)
    and the work that ended it."""
    starts = {r[1]: r[0] for r in launches.all()}
    out = []
    for s, e in sorted(_gaps(busy, start_ns, end_ns),
                       key=lambda g: g[0] - g[1])[:n]:
        where = "/".join(_parts(timeline.at(s))[-depth if depth else 0:])
        nxt = starts.get(e, "the window's end")
        out.append([f"{where}, before {nxt[:80]}", (e - s) / 1e9])
    return out


def idle_by_span(busy: list, timeline: Timeline, start_ns: int,
                 end_ns: int) -> dict:
    """``{path: idle seconds}``: every stretch with nothing on the card,
    given to the innermost span open at its start."""
    out: dict = {}
    for s, e in _gaps(busy, start_ns, end_ns):
        if e <= s:
            continue
        path = timeline.at(s)
        out[path] = out.get(path, 0.0) + (e - s) / 1e9
    return out


def table(by: dict, rounds: int) -> str:
    """One line a path: calls, host ms and device ms a round."""
    lines = [f"{'calls':>8} {'host ms/rd':>11} {'device ms/rd':>13}  path"]
    for path in sorted(by):
        dev, host, calls = by[path]
        lines.append(f"{calls:8d} {host / rounds * 1e3:11.3f} "
                     f"{dev / rounds * 1e3:13.3f}  {path}")
    return "\n".join(lines)
