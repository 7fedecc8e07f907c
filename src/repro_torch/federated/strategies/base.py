"""FLStrategy protocol + registry, port of
``repro.federated.strategies.base``.

An :class:`FLStrategy` packages what is algorithm-specific about a
federated round behind a fixed set of hooks, so the round builders in
:mod:`repro_torch.federated.server` share one round body:

- ``select(divs, uniform, k, u, n, device) -> (K, U) float32 selection
  matrix`` on ``device`` — which (client, layer-unit) pairs are uploaded
  and aggregated. ``divs`` is the (K, U) divergence matrix when
  :attr:`needs_divergence` is set, else ``None``. ``uniform`` is the
  round's algorithm stream, ``uniform(shape) -> f32 tensor in [0, 1)`` on
  ``device`` (the reference's per-round algorithm key; the same stream in
  both modes), or ``None`` when the caller gave the round none; the random
  policies draw from it.
- ``select_with_state(state, divs, uniform, k, u, n, device)`` — the
  engines' entry point; the default ignores ``state`` and calls
  ``select``.
- ``update_state(state, selection, divs, umap, uniform=None) -> state`` —
  the per-round state transition (identity by default).
- ``aggregate(uploads, umap, selection, data_sizes, global_params)`` — the
  server-side reduction over client-stacked uploads; the default is Eq. 5.
- ``psum_parts(uploads, umap, sel_loc, data_sizes, global_params=None)``
  / ``psum_finalize(parts, denom, umap, params, fallback)`` — the two
  halves of :meth:`aggregate` that the mesh round folds into its one
  cross-rank sum: additive partials over a rank's K/D clients, then the
  epilogue on every rank (also the packed uplink's epilogue). The defaults
  are Eq. 5; a strategy that overrides :meth:`aggregate` either overrides
  these to match or declares ``supports_mesh = False``.
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
  fused uplink kernels; ``uplink_psum_parts`` is its mesh half (additive
  partials of the rank's rows for the round's one cross-rank sum). Only
  consulted when :attr:`packed_upload` is set.
- ``comm_profile(selection, umap, param_bytes_override=None,
  unit_bytes_override=None) -> dict`` — per-round communication; the
  overrides reprice a compressed payload.

Cross-round state: ``init_state(params, num_clients, mesh=None) -> state |
None`` declares it once before round 0 (``None``, the default, is
stateless). A stateful strategy returns ``{"client": {name: store},
"global": {name: tree}}``; each client store's leaves carry a leading
``(num_clients,)`` axis, and the drivers hand the round the participants'
rows only. The error-feedback residual store is the client entry
``"residual"`` that the quantize wrapper declares. On a client mesh every
rank holds all N rows of a store (the reference's store, replicated over
its client-id axis): the round gets the rank's K/C rows, and the drivers
write the round's K new rows, all-gathered, into every rank's store.
``state_specs`` gives each entry's 'model'-axis specs: on a 2-D mesh a
param-shaped client entry is held as the rank's 1/M shard of every row,
like the params, and every other entry whole. In the mesh round, global
entries and the all-gathered divergences may drive selection on every rank
alike; client rows are the rank's own, so ``select_with_state`` and
``update_state`` touch them only row by row.

Per-strategy knobs: a strategy declares an :attr:`options_cls` dataclass;
``FLConfig(algo_options=...)`` carries an instance, resolved by
:meth:`FLStrategy.resolve_options` into ``self.opts``.

Capability flags read by ``FLConfig`` and the engines:

- ``needs_divergence`` — the engine computes the Eq. 3 divergence matrix
  (and accounts its feedback uplink) before calling ``select``.
- ``supports_mesh`` — the strategy can run client-sharded over a
  :class:`~repro_torch.launch.mesh.ClientMesh` (``FLConfig(mesh=...)``).
- ``supports_scan`` — the strategy can run under ``mode="scan"``:
  streamed through the Eq. 5 accumulator when ``eq5_weighted``, else with
  the sequentially trained locals stacked for :meth:`aggregate`.
- ``supports_quantize`` — the quantize(+EF) wrapper may be composed on top
  (``FLConfig(compression=CompressionConfig(...))``).
- ``eq5_weighted`` — aggregation is exactly Eq. 5 over the selection
  matrix, so the scan round may stream it through the accumulator.
- ``transforms_upload``, ``tracks_residuals``, ``packed_upload`` — engine
  dispatch for the hooks above.

Telemetry: ``telemetry_taps(state, selection, divs, umap) -> dict`` gives
the round's per-layer summaries for ``FLConfig(telemetry=...)`` (see
:meth:`FLStrategy.telemetry_taps`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core.units import UnitMap, tree_leaves, tree_map
from repro_torch.launch.mesh import model_mesh_size
from repro_torch.launch.sharding import fl_param_specs, shard_shape
from repro_torch.telemetry.taps import sq_sum

Pytree = Any


class FLStrategy:
    """Base strategy: Eq. 5 aggregation over a subclass-chosen selection."""

    # registry name; filled in by @register_strategy
    name: str = "?"
    # per-strategy options dataclass accepted through
    # FLConfig(algo_options=...); None = no knobs beyond FLConfig's own
    options_cls: Optional[type] = None
    # ---- capability flags (see module docstring) ----
    needs_divergence: bool = False
    supports_scan: bool = True
    supports_mesh: bool = True
    supports_quantize: bool = True
    eq5_weighted: bool = True
    # ---- engine dispatch flags ----
    transforms_upload: bool = False
    tracks_residuals: bool = False
    packed_upload: bool = False

    def __init__(self, cfg):
        self.cfg = cfg   # the FLConfig (strategies read knobs from it)
        self.opts = self.resolve_options(cfg)

    @classmethod
    def resolve_options(cls, cfg):
        """The strategy's options instance for ``cfg``: ``cfg.algo_options``
        (``FLConfig`` has already folded the deprecated flat knobs in), or
        the defaults for a cfg without one. ``None`` when the strategy
        declares no :attr:`options_cls`."""
        if cls.options_cls is None:
            return None
        opts = getattr(cfg, "algo_options", None)
        if opts is None:
            return cls.options_cls()
        if not isinstance(opts, cls.options_cls):
            raise TypeError(
                f"algo_options for strategy {cls.name!r} must be "
                f"{cls.options_cls.__name__}, got {type(opts).__name__}")
        return opts

    def init_state(self, params: Pytree, num_clients: int,
                   mesh=None) -> Optional[dict]:
        """Declare cross-round state; ``None`` (default) is stateless. On
        a 1-D ``mesh`` every rank holds the whole state, as without one."""
        return None

    def state_specs(self, params: Pytree, state: dict, mesh) -> dict:
        """Mesh placement of the state's entries: a dict of the state's
        shape holding, for each entry, a spec tree of its *trailing* dims
        (the reference's form). A param-shaped client entry (the params'
        structure, and each leaf's trailing shape the param leaf's, whole
        or as its shard on ``mesh``: a store created sharded) takes the
        params' :func:`~repro_torch.launch.sharding.fl_param_specs`;
        every other entry is replicated (``()``). Every client entry's
        rows are split by client coordinate in the round and
        all-gathered after it."""
        pspecs = fl_param_specs(params, mesh)
        m = 1 if mesh is None else model_mesh_size(mesh)
        pdef = tree_map(lambda _: None, params)
        whole = [tuple(l.shape) for l in tree_leaves(params)]
        shards = [shard_shape(s, spec, m)
                  for s, spec in zip(whole, tree_leaves(pspecs))]

        def entry_specs(entry, client: bool):
            if client and tree_map(lambda _: None, entry) == pdef and \
                    [tuple(l.shape[1:]) for l in tree_leaves(entry)] in (
                        whole, shards):
                return pspecs
            return tree_map(lambda _: (), entry)

        return {kind: {name: entry_specs(e, kind == "client")
                       for name, e in (state.get(kind) or {}).items()}
                for kind in ("client", "global")}

    def select_with_state(self, state: Optional[dict],
                          divs: Optional[torch.Tensor], uniform, k: int,
                          u: int, n: int, device) -> torch.Tensor:
        """State-aware selection — the engines' actual entry point. The
        default ignores ``state`` and delegates to :meth:`select`."""
        return self.select(divs, uniform, k, u, n, device)

    def update_state(self, state: Optional[dict], selection: torch.Tensor,
                     divs: Optional[torch.Tensor], umap: UnitMap,
                     uniform=None) -> Optional[dict]:
        """Per-round state transition (identity by default); runs once a
        round, after aggregation, and keeps every leaf's shape and dtype."""
        return state

    def select(self, divs: Optional[torch.Tensor], uniform, k: int, u: int,
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

    # ---- mesh halves of aggregate() (the round's one cross-rank sum) ----
    def psum_parts(self, uploads: Pytree, umap: UnitMap,
                   sel_loc: torch.Tensor, data_sizes: torch.Tensor,
                   global_params: Optional[Pytree] = None
                   ) -> tuple[Pytree, Pytree]:
        """Additive partials of this rank's K/D clients: param-structured
        f32 numerators and a denominator, the (U,) Eq. 5 weight sums or a
        param-structured tree (FedADP's element-wise counts).
        ``global_params`` is the global model, for strategies whose
        partials depend on it (FedADP's masks)."""
        return agg.stacked_psum_parts(uploads, umap, sel_loc, data_sizes)

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

    def uplink_psum_parts(self, locals_: Pytree, global_params: Pytree,
                          umap: UnitMap, sel_loc: torch.Tensor,
                          divs: Optional[torch.Tensor],
                          data_sizes: torch.Tensor,
                          res_rows: Optional[Pytree]
                          ) -> tuple[Pytree, torch.Tensor,
                                     Optional[Pytree], dict]:
        """Mesh half of :meth:`uplink_round` over this rank's K/D rows:
        ``(parts, denom, new_res_rows, wire)``, the additive Eq. 5
        numerators and denominator for the round's cross-rank sum (then
        :meth:`psum_finalize`), the rank's new residual rows and the wire
        accounting."""
        raise NotImplementedError(
            f"{type(self).__name__} sets packed_upload but does not "
            "implement uplink_psum_parts")

    def comm_profile(self, selection: torch.Tensor, umap: UnitMap,
                     param_bytes_override: float | None = None,
                     unit_bytes_override: torch.Tensor | None = None) -> dict:
        return comm_mod.round_comm(
            selection, umap, divergence_feedback=self.needs_divergence,
            param_bytes_override=param_bytes_override,
            unit_bytes_override=unit_bytes_override)

    # ---- telemetry taps (observability; read-only like every hook) ----
    # global-state entries of at most this many elements are passed through
    # verbatim (FedLAMA's (U,) interval/ttl vectors); larger entries are
    # summarised by their Frobenius norm instead.
    tap_passthrough_max: int = 256

    def telemetry_taps(self, state: Optional[dict],
                       selection: torch.Tensor,
                       divs: Optional[torch.Tensor],
                       umap: UnitMap) -> dict:
        """Per-round observability dict for
        ``FLConfig(telemetry=TelemetryConfig(taps=True))``: a flat ``{name:
        tensor}`` of small summaries recorded into the round ledger. Called
        once a round with ``selection`` the (K, U) matrix, ``divs`` the
        (K, U) Eq. 3 divergence matrix (or None) and ``state`` holding only
        the *global* entries (the round taps client rows itself). The key
        set is the same every round, and nothing may read a value on the
        host (the engine enqueues a block of rounds without a sync).

        Default: per-unit selection counts, per-unit divergence mean and
        max, and each global state entry: the tensor itself when it is a
        single leaf of at most :attr:`tap_passthrough_max` elements and at
        most one dimension (FedLAMA's (U,) interval/ttl vectors; the state
        seam replaces global entries each round, never in place), else its
        f32 norm. The size test reads static shapes only.
        """
        taps = {"sel_count": selection.sum(0)}
        if divs is not None:
            taps["div_mean"] = divs.mean(0)
            taps["div_max"] = divs.amax(0)
        if state and state.get("global"):
            for name, entry in state["global"].items():
                leaves = tree_leaves(entry)
                if len(leaves) == 1 and leaves[0].ndim <= 1 and \
                        leaves[0].numel() <= self.tap_passthrough_max:
                    taps[f"state_{name}"] = leaves[0]
                else:
                    taps[f"state_{name}_norm"] = torch.sqrt(sq_sum(leaves))
        return taps


# ======================================================================
# Registry
# ======================================================================
_REGISTRY: dict[str, type[FLStrategy]] = {}


def register_strategy(name: str, *, override: bool = False):
    """Class decorator: make ``FLConfig(algo=name)`` resolve to this
    strategy (and list it in ``ALGOS``).

    Registering a name taken by a *different* class raises (a plugin
    silently replacing e.g. the ``fedavg`` baseline would corrupt every
    savings-vs-fedavg comparison); pass ``override=True`` to replace it on
    purpose. Re-registering the same class is a no-op."""

    def deco(cls: type[FLStrategy]) -> type[FLStrategy]:
        if not (isinstance(cls, type) and issubclass(cls, FLStrategy)):
            raise TypeError(f"{cls!r} is not an FLStrategy subclass")
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls and not override:
            raise ValueError(
                f"strategy name {name!r} is already registered to "
                f"{existing.__name__}; pass register_strategy(name, "
                "override=True) to replace it")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def unregister_strategy(name: str) -> None:
    """Remove a registered strategy (tests / plugin teardown)."""
    _REGISTRY.pop(name, None)


def registered_algos() -> tuple[str, ...]:
    """Registered algorithm names, in registration order."""
    return tuple(_REGISTRY)


def strategy_registry() -> dict[str, type[FLStrategy]]:
    return dict(_REGISTRY)


def get_strategy_cls(name: str) -> type[FLStrategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown FL algorithm {name!r}; registered strategies: "
            f"{', '.join(sorted(_REGISTRY)) or '(none)'}") from None
