"""Device ms a round of the work launched under the program's
``moe.experts`` spans (the held experts' three products and SiLU, in each
forward and in the recompute of ``remat_blocks``; the evaluation's forward
too): :func:`bench.spans.subtree_device_ms`. ``None`` where the program
opens no such span. Layer: experts. Moves ``round_ms``."""
from bench import spans


def read(trace, run):
    by = trace.by_span
    return None if by is None else spans.subtree_device_ms(by, run.rounds,
                                                           "moe.experts")
