"""Device ms a round of the FL kernels (Eq. 3 divergence, Eq. 5 add,
packed uplink), found by the names in ``kernel_groups/fl_kernels.json``.
Layer: FL kernels. Moves ``round_ms``."""
from bench import spec


def read(trace, run):
    groups = spec.kernel_group("fl_kernels")
    seconds, count = trace.kernel_seconds(
        [p for ps in groups.values() for p in ps])
    if not count:
        return None
    return seconds / run.rounds * 1e3
