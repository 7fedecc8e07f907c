"""Share of the traced window in which nothing ran on the card: 1 − the
union of every kernel's and copy's interval over the window's wall time,
in %. Layer: device. Moves ``round_ms``: the host's pacing shows here."""


def read(trace, run):
    if not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
