"""Built-in strategies ported so far: the paper's FedLDF and FedAvg, port of
``repro.federated.strategies.builtin``. The other baselines (random, HDFL,
FedADP, FedLP, FedLAMA) are still to be ported (ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

from repro_torch.core import selection as sel
from repro_torch.federated.strategies.base import (FLStrategy,
                                                   register_strategy)


@register_strategy("fedldf")
class FedLDF(FLStrategy):
    """The paper's algorithm: top-n clients per layer-unit by divergence
    (Eq. 4), Eq. 5 aggregation, divergence-feedback uplink accounted."""

    needs_divergence = True

    def select(self, divs, generator, k, u, n, device):
        return sel.topn_divergence(divs, n)


@register_strategy("fedavg")
class FedAvg(FLStrategy):
    """Eq. 1: full participation, everything uploaded."""

    def select(self, divs, generator, k, u, n, device):
        return sel.full_participation(k, u, device)
