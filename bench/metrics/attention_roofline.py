"""The f32 attention kernel's share of its roofline, in %: its least time
a round, the causal products' FLOPs
(:func:`bench.yardstick.attention_flops_per_round`) at the f32 peak, over
its measured time. Layer: attention. Moves ``round_ms``."""
from bench import spec, yardstick


def read(trace, run):
    seconds, count = trace.kernel_seconds(
        spec.kernel_group("attention")["flash_fwd"])
    flops = yardstick.attention_flops_per_round(run.cfg, run.traffic)
    if not count or not flops:
        return None
    return 100.0 * flops * run.rounds / yardstick.F32_FLOPS / seconds
