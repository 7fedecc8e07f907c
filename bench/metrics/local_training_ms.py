"""Device ms a round of the work launched under the program's
``local_update`` spans (forward, backward, SGD, the attention backward):
:func:`bench.spans.local_training_ms`. Layer: local training. Moves
``round_ms``."""
from bench import spans


def read(trace, run):
    by = trace.by_span
    return None if by is None else spans.local_training_ms(by, run.rounds)
