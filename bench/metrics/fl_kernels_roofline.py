"""The FL kernels' share of their roofline, in %: Σ each kernel's least
time a round (the bytes it must read and write once, at the card's HBM
rate; :func:`bench.yardstick.fl_kernel_bytes_per_round`) over Σ its
measured time a round. Nothing when a kernel the round should launch is
missing from the trace. Layer: FL kernels. Moves ``round_ms``."""
from bench import spec, yardstick


def read(trace, run):
    groups = spec.kernel_group("fl_kernels")
    least = measured = 0.0
    for name, nbytes in yardstick.fl_kernel_bytes_per_round(
            run.cfg, run.traffic).items():
        seconds, count = trace.kernel_seconds(groups[name])
        if not count:
            return None
        least += nbytes / yardstick.HBM_BYTES_PER_S * run.rounds
        measured += seconds
    return 100.0 * least / measured if measured else None
