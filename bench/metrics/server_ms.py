"""Device ms a round of the work launched under the program's
``engine.*`` and ``round.*`` spans outside ``local_update``: the draws,
Eq. 3-5, the uplink, the state, the pull (:func:`bench.spans.server_ms`).
Layer: server. Moves ``round_ms``."""
from bench import spans


def read(trace, run):
    by = trace.by_span
    return None if by is None else spans.server_ms(by, run.rounds)
