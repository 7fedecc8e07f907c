"""Client-selection policies (Eq. 4 and FedAvg), port of
``repro.core.selection``.

Every policy produces a selection matrix ``s ∈ {0,1}^{K×U}`` (clients ×
layer-units). ``s[k, u] = 1`` iff layer-unit ``u`` of client ``k`` is
uploaded and enters the Eq. 5 aggregation. The random baselines (random,
HDFL, FedLP) are still to be ported (ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

import torch


def topn_divergence(divergence: torch.Tensor, n: int) -> torch.Tensor:
    """Eq. 4: top-n clients per layer-unit by divergence.

    divergence: (K, U) — ΔΘ_{k,u} from Eq. 3.
    Returns s: (K, U) float32 with exactly n ones per column. Among equal
    divergences the lower client index wins, as with ``jax.lax.top_k``:
    ``torch.topk`` promises no order for ties, so this takes a stable
    descending sort instead.
    """
    k, u = divergence.shape
    if not 1 <= n <= k:
        raise ValueError(f"top-n out of range: n={n}, K={k}")
    order = torch.sort(divergence.T, dim=1, descending=True,
                       stable=True).indices[:, :n]                # (U, n)
    sel = torch.zeros((u, k), dtype=torch.float32,
                      device=divergence.device)
    sel.scatter_(1, order, 1.0)
    return sel.T.contiguous()                                     # (K, U)


def full_participation(num_clients: int, num_units: int,
                       device) -> torch.Tensor:
    """FedAvg: s ≡ 1."""
    return torch.ones((num_clients, num_units), dtype=torch.float32,
                      device=device)
