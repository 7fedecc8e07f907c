"""FedLAMA: layer-wise adaptive aggregation intervals (arXiv:2110.10302),
port of ``repro.federated.strategies.fedlama``.

Layers drift from the global model at very different rates, and most of the
communication budget re-synchronises layers that have barely moved. FedLAMA
aggregates each layer on its own interval: layers whose accumulated
discrepancy-per-byte is low are synchronised every ``λ·τ'`` rounds instead
of every ``τ'`` rounds (``FedLAMAOptions(tau=τ', lam=λ)`` through
``FLConfig(algo_options=...)``).

The state is three replicated ``(U,)`` f32 vectors:

- ``ttl`` — rounds until each unit's next synchronisation (a unit is
  aggregated exactly when its ttl reaches 0; 0 at first, so round 0 is a
  full synchronisation that bootstraps the discrepancy estimate);
- ``interval`` — each unit's current interval τ_u ∈ {τ', λτ'};
- ``disc`` — the discrepancy d_u refreshed at each unit's sync rounds from
  the round's Eq. 3 matrix (``d_u = mean_k ΔΘ_{k,u}``).

Interval assignment (the paper's Alg. 2 cutoff): sort units by
discrepancy-per-byte ``δ_u = d_u / z_u`` ascending (a stable sort, as
``jnp.argsort``) and find the cutoff ``j*`` where the cumulative
discrepancy fraction ``ℓ_j`` balances the remaining cumulative size
fraction ``1 − s_j``; units up to the cutoff are demoted to λτ'.

A unit not synchronised this round keeps its previous global value (the
Eq. 5 zero-denominator fallback) and that round's local update to it is
discarded: uplink drops to about ``z·Σ_u 1/τ_u`` of FedAvg.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.units import UnitMap, tree_leaves
from repro_torch.federated.strategies.base import (FLStrategy,
                                                   register_strategy)


@dataclasses.dataclass(frozen=True)
class FedLAMAOptions:
    """FedLAMA knobs: base aggregation interval ``tau`` (τ') and the
    long-interval multiplier ``lam`` (λ)."""
    tau: int = 2
    lam: int = 2

    def __post_init__(self):
        if self.tau < 1 or self.lam < 1:
            raise ValueError(
                f"fedlama intervals must be >= 1, got tau={self.tau}"
                f" lam={self.lam}")


@register_strategy("fedlama")
class FedLAMA(FLStrategy):
    """Layer-wise adaptive aggregation intervals, driven by per-layer
    discrepancy accumulated across rounds in strategy state."""

    options_cls = FedLAMAOptions
    needs_divergence = True   # d_u comes from the round's Eq. 3 matrix

    def init_state(self, params, num_clients, mesh=None):
        u = UnitMap.build(params).num_units
        dev = tree_leaves(params)[0].device
        return {"global": {
            "ttl": torch.zeros((u,), dtype=torch.float32, device=dev),
            "interval": torch.full((u,), float(self.opts.tau),
                                   dtype=torch.float32, device=dev),
            "disc": torch.zeros((u,), dtype=torch.float32, device=dev),
        }}

    def select(self, divs, uniform, k, u, n, device):
        raise NotImplementedError(
            "fedlama selection is interval state-driven; the engines call "
            "select_with_state")

    def select_with_state(self, state, divs, uniform, k, u, n, device):
        # every participant uploads a unit exactly when its interval
        # expires: the sync mask broadcast over clients
        sync = (state["global"]["ttl"] <= 0.0).float()           # (U,)
        return sync[None, :].expand(k, u).contiguous()

    def _intervals(self, disc: torch.Tensor, umap: UnitMap) -> torch.Tensor:
        """Alg.-2 cutoff: τ_u = λτ' for low-discrepancy-per-byte units, τ'
        for the rest; τ' everywhere while no discrepancy has been observed
        (round 0)."""
        tau = float(self.opts.tau)
        lam = float(self.opts.lam)
        z = umap.unit_bytes_tensor(disc.device)                 # (U,) bytes
        order = torch.argsort(disc / z, stable=True)            # ascending
        d_sorted, z_sorted = disc[order], z[order]
        total_d = torch.sum(d_sorted)
        ell = torch.cumsum(d_sorted, 0) / torch.where(total_d > 0, total_d,
                                                      1.0)
        s = torch.cumsum(z_sorted, 0) / torch.sum(z_sorted)
        jstar = torch.argmin(torch.abs(ell - (1.0 - s)))        # balance
        long_sorted = torch.arange(disc.shape[0],
                                   device=disc.device) <= jstar
        tau_sorted = torch.where(long_sorted, lam * tau, tau)
        adaptive = tau_sorted[torch.argsort(order)]             # unsort
        return torch.where(total_d > 0, adaptive,
                           torch.full_like(adaptive, tau)).float()

    def update_state(self, state, selection, divs, umap, uniform=None):
        g = state["global"]
        sync = g["ttl"] <= 0.0                                  # (U,) bool
        disc = torch.where(sync, divs.mean(dim=0), g["disc"])
        interval = self._intervals(disc, umap)
        ttl = torch.where(sync, interval - 1.0, g["ttl"] - 1.0)
        return {**state, "global": {"ttl": ttl, "interval": interval,
                                    "disc": disc}}


def expected_round_bytes(umap: UnitMap, k: int, tau: int,
                         lam: int = 2) -> dict:
    """Modeled steady-state per-round uplink for the comm table.

    Without a discrepancy trace the split between τ' and λτ' units is
    unknown, so this brackets the average round: ``hi`` assumes every unit
    stays on the base interval (payload = FedAvg/τ'), ``lo`` that every
    unit is demoted to λτ'. Both include the per-round divergence-feedback
    vector (K·U float32 scalars) that drives the interval adaptation.
    """
    feedback = float(k * umap.num_units * 4)
    full = float(k * umap.total_bytes)
    return {"hi": full / tau + feedback,
            "lo": full / (lam * tau) + feedback}
