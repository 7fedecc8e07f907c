"""Client-selection policies (Eq. 4 and the paper's baselines), port of
``repro.core.selection``.

Every policy produces a selection matrix ``s ∈ {0,1}^{K×U}`` (clients ×
layer-units). ``s[k, u] = 1`` iff layer-unit ``u`` of client ``k`` is
uploaded and enters the Eq. 5 aggregation.

- :func:`topn_divergence` — FedLDF (Eq. 4): per unit, the n clients with
  the largest divergence.
- :func:`random_per_layer` — "random" baseline: per unit, n uniform clients.
- :func:`client_dropout` — HDFL baseline [7]: n whole clients, all units.
- :func:`full_participation` — FedAvg: everything.
- :func:`bernoulli_per_layer` — FedLP: each (client, unit) kept
  independently with probability p.

The random policies take the round's algorithm stream as ``uniform(shape)
-> f32 tensor in [0, 1)`` on the round's device (the reference takes a PRNG
key and draws ``jax.random.uniform`` from it), so the same uniforms give
the same selection in both packages.
"""
from __future__ import annotations

from typing import Callable

import torch

Uniform = Callable[[tuple], torch.Tensor]


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


def _top_rows(scores: torch.Tensor, n: int) -> torch.Tensor:
    """(K,) f32 indicator of the n largest scores; among equal scores the
    lower index wins (``jax.lax.top_k``'s order)."""
    order = torch.sort(scores, descending=True, stable=True).indices[:n]
    return torch.zeros(scores.shape[0], dtype=torch.float32,
                       device=scores.device).scatter_(0, order, 1.0)


def random_per_layer(uniform: Uniform, num_clients: int, num_units: int,
                     n: int) -> torch.Tensor:
    """Random baseline: per unit, choose n clients uniformly at random."""
    return topn_divergence(uniform((num_clients, num_units)), n)


def client_dropout(uniform: Uniform, num_clients: int, num_units: int,
                   n: int) -> torch.Tensor:
    """HDFL [7]: choose n whole clients; they upload *all* units."""
    rows = _top_rows(uniform((num_clients,)), n)
    return rows[:, None].expand(num_clients, num_units).contiguous()


def bernoulli_per_layer(uniform: Uniform, num_clients: int, num_units: int,
                        p: float) -> torch.Tensor:
    """FedLP layer-wise probabilistic participation: client k uploads unit
    u with probability ``p``, independently per (client, unit). Columns may
    come up empty — Eq. 5 consumers fall back to the previous global value
    for units nobody kept."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"keep probability out of range: p={p}")
    return (uniform((num_clients, num_units)) < p).float()
