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
- ``psum_finalize(parts, denom, umap, params, fallback)`` — the epilogue
  of Eq. 5 over additive numerators (the packed uplink's).
- ``transform_upload(local, global_params, umap, residual) -> (upload,
  candidate_residual)`` — per-client payload transform (identity by
  default; the legacy compression chain quantizes here). Only consulted
  when :attr:`transforms_upload` is set.
- ``update_residual(cand_res, old_res, sel_row, umap, global_params)`` —
  per-client error-feedback residual update, gated on the selection row.
  Only consulted when :attr:`tracks_residuals` is set.
- ``uplink_round(locals_, global_params, umap, selection, divs,
  data_sizes, res_rows) -> (new_params, new_res_rows, wire)`` — the packed
  uplink: stacked locals become a packed wire payload reduced through the
  fused uplink kernels. Only consulted when :attr:`packed_upload` is set.
- ``comm_profile(selection, umap, param_bytes_override=None,
  unit_bytes_override=None) -> dict`` — per-round communication; the
  overrides reprice a compressed payload.

Cross-round state: ``init_state(params, num_clients) -> state | None``
declares it once before round 0 (``None``, the default, is stateless). A
stateful strategy returns ``{"client": {name: store}, "global": {name:
tree}}``; each client store's leaves carry a leading ``(num_clients,)``
axis, and run_training hands the round the participants' rows only. The
error-feedback residual store is the client entry ``"residual"`` that the
quantize wrapper declares.

Capability flags read by ``FLConfig`` and the engines:

- ``needs_divergence`` — the engine computes the Eq. 3 divergence matrix
  (and accounts its feedback uplink) before calling ``select``.
- ``supports_scan`` — the strategy can run under ``mode="scan"``.
- ``supports_quantize`` — the quantize(+EF) wrapper may be composed on top
  (``FLConfig(compression=CompressionConfig(...))``).
- ``eq5_weighted`` — aggregation is exactly Eq. 5 over the selection
  matrix, so the scan round may stream it through the accumulator.
- ``transforms_upload``, ``tracks_residuals``, ``packed_upload`` — engine
  dispatch for the hooks above.

The reference's mesh hooks (``supports_mesh``, ``psum_parts``,
``uplink_psum_parts``, ``state_specs``) and telemetry taps wait for their
slices (ROADMAP Queue 1, items 8 and 11).
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
    supports_quantize: bool = True
    eq5_weighted: bool = True
    # ---- engine dispatch flags ----
    transforms_upload: bool = False
    tracks_residuals: bool = False
    packed_upload: bool = False

    def __init__(self, cfg):
        self.cfg = cfg   # the FLConfig (strategies read knobs from it)

    def init_state(self, params: Pytree, num_clients: int) -> Optional[dict]:
        """Declare cross-round state; ``None`` (default) is stateless."""
        return None

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

    def transform_upload(self, local: Pytree, global_params: Pytree,
                         umap: UnitMap, residual: Optional[Pytree]
                         ) -> tuple[Pytree, Optional[Pytree]]:
        return local, None

    def update_residual(self, cand_res: Pytree, old_res: Optional[Pytree],
                        sel_row: torch.Tensor, umap: UnitMap,
                        global_params: Pytree) -> Pytree:
        raise NotImplementedError

    def aggregate(self, uploads: Pytree, umap: UnitMap,
                  selection: torch.Tensor, data_sizes: torch.Tensor,
                  global_params: Pytree) -> Pytree:
        return agg.aggregate_stacked(uploads, umap, selection, data_sizes,
                                     fallback=global_params)

    def psum_finalize(self, parts: Pytree, denom: torch.Tensor,
                      umap: UnitMap, params: Pytree,
                      fallback: Pytree | None) -> Pytree:
        return agg.stacked_psum_finalize(parts, denom, umap, params,
                                         fallback)

    def uplink_round(self, locals_: Pytree, global_params: Pytree,
                     umap: UnitMap, selection: torch.Tensor,
                     divs: Optional[torch.Tensor], data_sizes: torch.Tensor,
                     res_rows: Optional[Pytree]
                     ) -> tuple[Pytree, Optional[Pytree], dict]:
        """Packed round: stacked client ``locals_`` → ``(new_global_params,
        new_residual_rows, wire)``, where ``wire`` holds the payload's
        accounting (``unit_bytes`` (U,), ``bits`` (U,), ``nbytes``), fed to
        :meth:`comm_profile` through ``unit_bytes_override``."""
        raise NotImplementedError(
            f"{type(self).__name__} sets packed_upload but does not "
            "implement uplink_round")

    def comm_profile(self, selection: torch.Tensor, umap: UnitMap,
                     param_bytes_override: float | None = None,
                     unit_bytes_override: torch.Tensor | None = None) -> dict:
        return comm_mod.round_comm(
            selection, umap, divergence_feedback=self.needs_divergence,
            param_bytes_override=param_bytes_override,
            unit_bytes_override=unit_bytes_override)


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
