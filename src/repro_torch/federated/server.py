"""ServerExecute (paper Algorithm 1) — round builders + the host driver,
port of ``repro.federated.server``.

Two per-round execution modes give the same aggregation semantics:

- ``vmap``: all K clients train stacked under ``torch.func.vmap`` and their
  models are materialised with a leading client axis — the paper's own
  regime (small models, many clients). The Eq. 3 divergence of all K
  clients is one ``sqdiff_rowsum`` kernel call over every parameter leaf
  (one a client in ``scan`` mode).
- ``scan``: clients run one after another. FedLDF needs all K divergence
  vectors *before* deciding what to aggregate, so the round runs two
  passes of deterministic local training (phase 1: divergence only;
  phase 2: recompute and stream the selected layers into an f32
  accumulator through the ``masked_accumulate`` kernel, one launch a
  client over all its leaves). Memory is O(1) clients.

``FLConfig(compression=CompressionConfig(...))`` quantizes every uploaded
layer into int8 or int4 levels plus a per-unit scale, with optional
client-side error feedback: the vmap round then reduces the packed payload
through the fused uplink kernels (``strategy.uplink_round``), or through
the legacy unfused chain with ``CompressionConfig(fused=False)``. The scan
round refuses compression, as the reference's does.

:func:`run_training` is the host-loop driver with the reference's numpy
("host") sampler, so one seed gives the same clients and batches as
``repro.federated.run_training(sampler="host")``. It threads strategy
state across rounds (the error-feedback residual store is one).

Numerics: the round builders switch TF32 off for cuDNN convolutions and
CUDA matmuls (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``, process-wide). TF32, PyTorch's
default for convolutions, keeps about three decimal digits; the port holds
its rounds to the f32 reference, and Eq. 4 ranks the Eq. 3 values, so the
rounds run in full f32.

Not yet ported (ROADMAP Queue 1): the device-resident multi-round engine
``run_training_scan``, the JAX-key sampler, the compiled-callable cache,
resume (``start_round``/``server_state``), mesh sharding, the deprecated
flat ``quantize_bits``/``error_feedback`` knobs, trainable partitions and
telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core.units import UnitMap, tree_map, tree_stack_index
from repro_torch.core.wire import CompressionConfig
from repro_torch.federated.client import make_local_update
from repro_torch.federated.sampling import sample_clients
from repro_torch.federated.strategies import get_strategy_cls, make_strategy
from repro_torch.optim.opt import Optimizer, sgd

Pytree = Any

# Raised when compression=CompressionConfig(...) meets the sequential-client
# scan round; word for word the reference's message.
_SCAN_COMPRESSION_MSG = (
    "compression=CompressionConfig(...) is not supported by the "
    "sequential-client scan engine (mode='scan'): the packed quantized "
    "uplink reduces a stacked client axis. Supported drivers: mode='vmap' "
    "on a single device, the mesh-sharded round (FLConfig(mesh=...)), and "
    "both multi-round drivers (run_training / run_training_scan) on top of "
    "them.")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    algo: str = "fedldf"
    num_clients: int = 50          # N
    clients_per_round: int = 20    # K
    top_n: int = 4                 # n (per-layer uploads)
    local_steps: int = 1
    lr: float = 0.05
    mode: str = "vmap"             # vmap | scan
    # uplink compression policy (repro_torch.core.wire.CompressionConfig):
    # packed quantized uploads + optional error feedback + divergence-driven
    # bit allocation (bits="auto"). None = f32 uploads.
    compression: Optional[CompressionConfig] = None
    batch_per_client: int = 32

    def __post_init__(self):
        # unknown algos raise ValueError; reference algos not ported yet
        # raise NotImplementedError
        scls = get_strategy_cls(self.algo)
        if self.mode not in ("vmap", "scan"):
            raise ValueError(f"FLConfig.mode must be 'vmap' or 'scan', got "
                             f"{self.mode!r}")
        if not 1 <= self.top_n <= self.clients_per_round:
            raise ValueError(f"top_n={self.top_n} out of range for "
                             f"K={self.clients_per_round}")
        comp = self.compression
        if comp is not None and not isinstance(comp, CompressionConfig):
            raise TypeError(
                "FLConfig.compression must be a repro_torch.core.wire."
                f"CompressionConfig or None, got {type(comp)}")
        if comp is not None and not scls.supports_quantize:
            raise ValueError(
                f"strategy {self.algo!r} declares supports_quantize=False")
        if self.mode == "scan":
            if not scls.supports_scan:
                raise ValueError(
                    f"strategy {self.algo!r} declares supports_scan=False")
            if comp is not None:
                raise NotImplementedError(_SCAN_COMPRESSION_MSG)


def _full_fp32() -> None:
    """Full-f32 convolutions and matmuls on the card (see module doc)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ======================================================================
# Round builders
# ======================================================================
def build_round_vmap(loss_fn, umap: UnitMap, flcfg: FLConfig,
                     opt: Optimizer | None = None):
    """Round function with parallel (stacked) clients:
    ``round_fn(params, batch, data_sizes, state=None) -> (new_params,
    metrics)`` with batch leaves ``(K, B, ...)`` and ``metrics`` holding
    ``loss``, ``comm``, ``selection``, ``divergence`` (the (K, U) Eq. 3
    matrix, or None), ``wire`` (the packed payload's accounting, or None)
    and, when a ``state`` is given, the updated ``state``.

    With error feedback ``state`` is required: its client entry
    ``"residual"`` holds the participants' (K, ...) residual rows (see
    :func:`run_training`)."""
    _full_fp32()
    opt = opt or sgd(flcfg.lr)
    train_clients = torch.func.vmap(
        make_local_update(loss_fn, opt, flcfg.local_steps), in_dims=(None, 0))
    strategy = make_strategy(flcfg)
    k = flcfg.clients_per_round

    def round_fn(params: Pytree, batch: dict, data_sizes: torch.Tensor,
                 state: Optional[dict] = None):
        locals_, losses = train_clients(params, batch)
        # Eq. 3 on the client-stacked locals: one launch per leaf
        divs = (umap.divergence(locals_, params)
                if strategy.needs_divergence else None)
        selection = strategy.select_with_state(
            state, divs, None, k, umap.num_units, flcfg.top_n,
            data_sizes.device)
        res_rows = None
        if strategy.tracks_residuals:
            if state is None:
                raise ValueError(
                    "error feedback needs the participants' residual rows: "
                    "pass state=strategy.init_state(...) rows (run_training "
                    "does)")
            res_rows = state["client"]["residual"]

        wire = None
        if strategy.packed_upload:
            # packed wire-format uplink: the strategy quantizes the client
            # deltas into PackedPayload buffers and reduces them through
            # the fused uplink kernels: one launch a round over every
            # leaf, or one a leaf with error feedback
            new_params, new_rows, wire = strategy.uplink_round(
                locals_, params, umap, selection, divs, data_sizes,
                res_rows)
            comm = strategy.comm_profile(
                selection, umap, unit_bytes_override=wire["unit_bytes"])
        else:
            uploads, new_rows = locals_, None
            if strategy.transforms_upload:
                # e.g. quantized deltas: the server reconstructs
                # Ĝ + dequant(Q(Δ + e)) client by client; error-feedback
                # residuals advance only where a layer was uploaded
                outs = [strategy.transform_upload(
                    tree_stack_index(locals_, i), params, umap,
                    None if res_rows is None
                    else tree_stack_index(res_rows, i)) for i in range(k)]
                uploads = tree_map(lambda *ls: torch.stack(ls),
                                   *(o[0] for o in outs))
                if strategy.tracks_residuals:
                    rows = [strategy.update_residual(
                        outs[i][1], tree_stack_index(res_rows, i),
                        selection[i], umap, params) for i in range(k)]
                    new_rows = tree_map(lambda *ls: torch.stack(ls), *rows)
            new_params = strategy.aggregate(uploads, umap, selection,
                                            data_sizes, params)
            comm = strategy.comm_profile(selection, umap)
        if strategy.tracks_residuals:
            state = {**state, "client": {**state["client"],
                                         "residual": new_rows}}
        metrics = {"loss": losses.mean(), "comm": comm,
                   "selection": selection, "divergence": divs,
                   "wire": wire}
        if state is not None:
            metrics["state"] = strategy.update_state(state, selection, divs,
                                                     umap)
        return new_params, metrics

    return round_fn


def build_round_scan(loss_fn, umap: UnitMap, flcfg: FLConfig,
                     opt: Optimizer | None = None):
    """Round function with sequential clients + two-phase recompute; same
    signature and metrics as :func:`build_round_vmap`.

    Memory: O(global + 1 local + 1 accumulator) models, independent of K —
    selected layers are streamed into the Eq. 5 accumulator as each client
    trains. Only Eq. 5 strategies (``eq5_weighted``) are supported so far;
    the reference's stacked phase 2 for other aggregations waits for FedADP
    (ROADMAP Queue 1, item 6).
    """
    if flcfg.compression is not None:
        raise NotImplementedError(_SCAN_COMPRESSION_MSG)
    _full_fp32()
    strategy = make_strategy(flcfg)
    if not strategy.supports_scan:
        raise NotImplementedError(
            f"strategy {strategy.name!r} declares supports_scan=False")
    if not strategy.eq5_weighted:
        raise NotImplementedError(
            f"strategy {strategy.name!r} is not Eq. 5-weighted; its scan "
            "round is not ported yet (ROADMAP Queue 1, item 6)")
    local_update = make_local_update(loss_fn, opt or sgd(flcfg.lr),
                                     flcfg.local_steps)
    k = flcfg.clients_per_round

    def round_fn(params: Pytree, batch: dict, data_sizes: torch.Tensor,
                 state: Optional[dict] = None):
        client_batches = [{name: v[i] for name, v in batch.items()}
                          for i in range(k)]
        # ---- phase 1: divergence feedback (only if the policy needs it)
        divs = losses1 = None
        if strategy.needs_divergence:
            rows, losses1 = [], []
            for batch_k in client_batches:
                local, loss = local_update(params, batch_k)
                rows.append(umap.divergence(local, params))
                losses1.append(loss)
            divs, losses1 = torch.stack(rows), torch.stack(losses1)

        selection = strategy.select_with_state(
            state, divs, None, k, umap.num_units, flcfg.top_n,
            data_sizes.device)
        w, denom = agg.unit_weights(selection, data_sizes)
        frac = w / torch.where(denom > 0, denom,
                               torch.ones_like(denom))[None, :]   # (K, U)

        # ---- phase 2: recompute local training, stream layers in
        acc = agg.streaming_init(params)
        losses2 = []
        for batch_k, frac_k in zip(client_batches, frac):
            local, loss = local_update(params, batch_k)
            agg.streaming_add(acc, local, umap, frac_k)
            losses2.append(loss)
        new_params = agg.streaming_finalize(acc, umap, denom, params)

        loss = (losses1 if losses1 is not None
                else torch.stack(losses2)).mean()
        metrics = {"loss": loss,
                   "comm": strategy.comm_profile(selection, umap),
                   "selection": selection, "divergence": divs}
        if state is not None:
            metrics["state"] = strategy.update_state(state, selection, divs,
                                                     umap)
        return new_params, metrics

    return round_fn


def build_round_fn(loss_fn, umap: UnitMap, flcfg: FLConfig,
                   opt: Optimizer | None = None):
    if flcfg.mode == "vmap":
        return build_round_vmap(loss_fn, umap, flcfg, opt)
    return build_round_scan(loss_fn, umap, flcfg, opt)


# ======================================================================
# Multi-round driver
# ======================================================================
@dataclasses.dataclass
class TrainLog:
    rounds: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    test_errors: list = dataclasses.field(default_factory=list)
    uplink_mb: list = dataclasses.field(default_factory=list)
    meter: comm_mod.CommMeter = dataclasses.field(
        default_factory=comm_mod.CommMeter)
    # strategy state after the last round (None for stateless strategies)
    final_state: Optional[dict] = None


# Strategy state is ``{"client": {name: (N, ...) store}, "global": {name:
# tree}}`` or None (see FLStrategy.init_state). The helpers below are the
# only state plumbing run_training needs; the EF residual store is just the
# client entry named "residual" that the quantize wrapper declares.
def _scatter_rows(store: Pytree, clients: torch.Tensor,
                  rows: Pytree) -> Pytree:
    """Write the participants' rows back into the (N, ...) store **in
    place** (run_training owns the store; a functional copy would move the
    whole N × model store every round). The explicit cast keeps each
    leaf's own dtype: the EF arithmetic runs in f32."""
    def put(full, r):
        full[clients] = r.to(full.dtype)
        return full

    return tree_map(put, store, rows)


def _state_round_view(state: Optional[dict], clients) -> Optional[dict]:
    """Round-local view of the state: client stores are replaced by the
    participants' gathered ``(K, ...)`` rows; global entries pass through."""
    if not state or not state.get("client"):
        return state
    return {**state, "client": {n_: tree_map(lambda l: l[clients], s)
                                for n_, s in state["client"].items()}}


def _state_scatter(state: Optional[dict], new_state: dict,
                   clients) -> Optional[dict]:
    """Persist a round's updated state: client rows are scattered back into
    the ``(N, ...)`` stores, global entries are replaced wholesale."""
    if state is None:
        return None
    out = dict(new_state)
    if state.get("client"):
        out["client"] = {n_: _scatter_rows(state["client"][n_], clients, r)
                         for n_, r in new_state["client"].items()}
    return out


def run_training(params: Pytree, loss_fn, fldata, flcfg: FLConfig,
                 rounds: int,
                 eval_fn: Optional[Callable[[Pytree], float]] = None,
                 eval_every: int = 10, seed: int = 0,
                 sampler: str = "host", device="cuda"
                 ) -> tuple[Pytree, TrainLog]:
    """Full FL training loop (paper Algorithm 1 ServerExecute), host-driven.

    One Python iteration per round: numpy client sampling and batch
    gathering from ``fldata`` (a :class:`~repro_torch.data.FederatedData`)
    with the reference's ``sampler="host"`` stream, a round on ``device``
    (the card unless the caller asks for ``"cpu"``), and one host pull of
    the loss and comm stats. ``params`` are moved to ``device``.

    Strategy state (the error-feedback residual store, any
    :meth:`FLStrategy.init_state` schema) is declared once and threaded
    through the rounds: client-entry rows are gathered before a round and
    scattered back after, and the final state lands in
    ``log.final_state``. The reference's ``sampler="jax"`` key schedule
    and its resume arguments are still to be ported (ROADMAP Queue 1,
    item 7).
    """
    if sampler != "host":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet (ROADMAP Queue 1, "
            "item 7); the port has the reference's 'host' sampler")
    params = tree_map(lambda l: l.to(device), params)
    umap = UnitMap.build(params)
    round_fn = build_round_fn(loss_fn, umap, flcfg)
    state = make_strategy(flcfg).init_state(params, flcfg.num_clients)
    log = TrainLog()
    rng = np.random.default_rng(seed)
    all_sizes = fldata.data_sizes()
    for t in range(rounds):
        clients = sample_clients(rng, flcfg.num_clients,
                                 flcfg.clients_per_round)
        batch = fldata.round_batch(clients, flcfg.batch_per_client, rng)
        batch = {name: torch.from_numpy(v).to(device)
                 for name, v in batch.items()}
        sizes = torch.from_numpy(all_sizes[clients]).to(device)
        if state is not None:
            idx = torch.from_numpy(clients).to(device)
            params, metrics = round_fn(params, batch, sizes,
                                       _state_round_view(state, idx))
            state = _state_scatter(state, metrics["state"], idx)
        else:
            params, metrics = round_fn(params, batch, sizes)
        log.meter.update(metrics["comm"])
        log.rounds.append(t)
        loss_t = float(metrics["loss"])     # device sync
        log.losses.append(loss_t)
        log.uplink_mb.append(log.meter.uplink_bytes / 1e6)
        if eval_fn is not None and (t % eval_every == 0 or t == rounds - 1):
            err = float(eval_fn(params))
            log.test_errors.append((t, err, log.meter.uplink_bytes))
    log.final_state = state
    return params, log
