"""The whole round's model FLOPs utilisation, in %: a round's model FLOPs
(:func:`bench.yardstick.round_model_flops`: training's forward and
backward, the evaluation's forward, not the scan round's recompute) times
the traced rounds, over the traced window's wall time at the f32 peak.
Layer: whole step. Moves ``round_ms``; it bounds every kernel's roofline
that a later change takes off the path."""
from bench import yardstick


def read(trace, run):
    flops = yardstick.round_model_flops(run.cfg, run.traffic) * run.rounds
    return 100.0 * flops / (run.window_s * yardstick.F32_FLOPS)
