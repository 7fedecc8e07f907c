"""FLStrategy protocol + registry, port of
``repro.federated.strategies.base``.

An :class:`FLStrategy` packages what is algorithm-specific about a
federated round behind a fixed set of hooks, so the round builders in
:mod:`repro_torch.federated.server` share one round body:

- ``select(divs, generator, k, u, n, device) -> (K, U) float32 selection
  matrix`` on ``device`` — which (client, layer-unit) pairs are uploaded
  and aggregated. ``divs`` is the (K, U) divergence matrix when
  :attr:`needs_divergence` is set, else ``None``. ``generator`` is
  reserved for the random policies, which are still to be ported.
- ``select_with_state(state, divs, generator, k, u, n, device)`` — the
  engines' entry point; the default ignores ``state`` and calls
  ``select``.
- ``update_state(state, selection, divs, umap) -> state`` — the per-round
  state transition (identity by default).
- ``aggregate(uploads, umap, selection, data_sizes, global_params)`` — the
  server-side reduction over client-stacked uploads; the default is Eq. 5.
- ``comm_profile(selection, umap) -> dict`` — per-round communication.

Capability flags read by ``FLConfig`` and the engines:

- ``needs_divergence`` — the engine computes the Eq. 3 divergence matrix
  (and accounts its feedback uplink) before calling ``select``.
- ``supports_scan`` — the strategy can run under ``mode="scan"``.
- ``eq5_weighted`` — aggregation is exactly Eq. 5 over the selection
  matrix, so the scan round may stream it through the accumulator.

The reference's mesh, compression and packed-uplink hooks and its
cross-round state stores wait for their slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core.units import UnitMap

Pytree = Any

# Registered in the reference but not ported yet: asking for one of these
# names is a NotImplementedError, not an unknown-algorithm ValueError.
NOT_YET_PORTED = ("random", "hdfl", "fedadp", "fedlp", "fedlama")


class FLStrategy:
    """Base strategy: Eq. 5 aggregation over a subclass-chosen selection."""

    # registry name; filled in by @register_strategy
    name: str = "?"
    # ---- capability flags (see module docstring) ----
    needs_divergence: bool = False
    supports_scan: bool = True
    eq5_weighted: bool = True

    def __init__(self, cfg):
        self.cfg = cfg   # the FLConfig (strategies read knobs from it)

    def select_with_state(self, state: Optional[dict],
                          divs: Optional[torch.Tensor], generator, k: int,
                          u: int, n: int, device) -> torch.Tensor:
        """State-aware selection — the engines' actual entry point. The
        default ignores ``state`` and delegates to :meth:`select`."""
        return self.select(divs, generator, k, u, n, device)

    def update_state(self, state: Optional[dict], selection: torch.Tensor,
                     divs: Optional[torch.Tensor],
                     umap: UnitMap) -> Optional[dict]:
        """Per-round state transition (identity by default)."""
        return state

    def select(self, divs: Optional[torch.Tensor], generator, k: int, u: int,
               n: int, device) -> torch.Tensor:
        raise NotImplementedError

    def aggregate(self, uploads: Pytree, umap: UnitMap,
                  selection: torch.Tensor, data_sizes: torch.Tensor,
                  global_params: Pytree) -> Pytree:
        return agg.aggregate_stacked(uploads, umap, selection, data_sizes,
                                     fallback=global_params)

    def comm_profile(self, selection: torch.Tensor, umap: UnitMap) -> dict:
        return comm_mod.round_comm(
            selection, umap, divergence_feedback=self.needs_divergence)


# ======================================================================
# Registry
# ======================================================================
_REGISTRY: dict[str, type[FLStrategy]] = {}


def register_strategy(name: str):
    """Class decorator: make ``FLConfig(algo=name)`` resolve to this
    strategy. Registering a taken name with a different class raises;
    re-registering the same class is a no-op."""

    def deco(cls: type[FLStrategy]) -> type[FLStrategy]:
        if not (isinstance(cls, type) and issubclass(cls, FLStrategy)):
            raise TypeError(f"{cls!r} is not an FLStrategy subclass")
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"strategy name {name!r} is already registered to "
                f"{existing.__name__}; unregister_strategy it first")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def unregister_strategy(name: str) -> None:
    """Remove a registered strategy (tests / plugin teardown)."""
    _REGISTRY.pop(name, None)


def get_strategy_cls(name: str) -> type[FLStrategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_YET_PORTED:
            raise NotImplementedError(
                f"FL algorithm {name!r} is not ported to PyTorch yet "
                "(ROADMAP Queue 1, item 6); ported: "
                f"{', '.join(_REGISTRY)}") from None
        raise ValueError(
            f"unknown FL algorithm {name!r}; registered strategies: "
            f"{', '.join(sorted(_REGISTRY)) or '(none)'}") from None
