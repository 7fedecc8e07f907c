"""Device ms a round of the work launched under the program's
``moe.route`` and ``moe.combine`` spans (the router, its top-k and gates,
the balance loss; the gated sum of the held experts' outputs):
:func:`bench.spans.subtree_device_ms` of each, added. ``None`` where the
program opens neither. Layer: experts. Moves ``round_ms``."""
from bench import spans


def read(trace, run):
    by = trace.by_span
    if by is None:
        return None
    parts = [spans.subtree_device_ms(by, run.rounds, name)
             for name in ("moe.route", "moe.combine")]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
