"""Participant sampling (Algorithm 1 line 5: C_t ← random(K, max(C·N, 1))),
port of ``repro.federated.sampling``.

Host-side numpy sampling: the same stream as the reference's host sampler,
so one seed gives the same participants in both packages. The device-side
samplers of the reference (``sample_clients_jax``, ``round_keys``) wait for
the multi-round engine (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import numpy as np


def sample_clients(rng: np.random.Generator, num_clients: int,
                   k: int) -> np.ndarray:
    """Uniformly sample K distinct participants for this round (host RNG)."""
    k = max(1, min(k, num_clients))
    return rng.choice(num_clients, size=k, replace=False)
