"""Per-client state stores, port of ``repro.launch.sharding`` for the 1-D
client mesh: every rank holds the whole store, as the reference's store is
replicated over its ``'clients'`` axis. The 'model'-axis placement
(``fl_param_specs``, ``residual_store_specs``, a store sharded 1/M a
device) comes with the 2-D mesh, the next slice of ROADMAP Queue 1, item
11.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.units import tree_map

Pytree = Any


def init_residual_store(params: Pytree, num_clients: int,
                        mesh=None) -> Pytree:
    """Per-client error-feedback residual store: every leaf gets a leading
    ``(N,)`` client axis, zero-initialised on the leaf's device **in the
    leaf's own dtype**. Rows for the round's participants are gathered
    before the round and scattered back after: residuals belong to
    clients, not to sampling slots. At N × model size this store is the
    round's largest buffer (942 MB for full-width VGG-9 at N = 50). On a
    1-D ``mesh`` every rank holds all N rows (any client can be sampled
    onto any rank), on the params' device, the rank's."""
    return tree_map(lambda l: torch.zeros((num_clients,) + tuple(l.shape),
                                          dtype=l.dtype, device=l.device),
                    params)
