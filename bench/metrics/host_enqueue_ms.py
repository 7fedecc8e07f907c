"""Host wall ms a round inside the program's ``engine.round`` spans, in
the traced window (:func:`bench.spans.host_enqueue_ms`): the host's
enqueue of a round's work, and every wait inside it (a full launch
queue, the allocator's retry), slowed by the profiler's cost a launch.
Layer: engine. Moves ``round_ms`` where the host paces the round."""
from bench import spans


def read(trace, run):
    by = trace.by_span
    return None if by is None else spans.host_enqueue_ms(by, run.rounds)
