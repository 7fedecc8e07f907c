"""Device ms a round of the work launched under the program's
``attention.bwd`` spans (route 5d, the attention's backward):
:func:`bench.spans.attention_bwd_ms`. Layer: attention. Moves
``round_ms``."""
from bench import spans


def read(trace, run):
    by = trace.by_span
    return None if by is None else spans.attention_bwd_ms(by, run.rounds)
