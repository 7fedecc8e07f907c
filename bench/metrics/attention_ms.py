"""Device ms a round of the f32 attention kernel (route 5c), found by the
names in ``kernel_groups/attention.json``: every forward of local
training, the scan round's recompute and the evaluation. Layer:
attention. Moves ``round_ms``."""
from bench import spec


def read(trace, run):
    seconds, count = trace.kernel_seconds(
        spec.kernel_group("attention")["flash_fwd"])
    if not count:
        return None
    return seconds / run.rounds * 1e3
