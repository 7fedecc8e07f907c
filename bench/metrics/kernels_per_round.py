"""Device kernels in the traced window over its rounds (the evaluation's
included). Layer: engine (``run_training_scan`` -> ``_build_block_fn``):
the host pays for each launch, so fewer launches a round move
``round_ms`` where the host paces the round."""


def read(trace, run):
    if not trace.kernels:
        return None
    return len(trace.kernels) / run.rounds
