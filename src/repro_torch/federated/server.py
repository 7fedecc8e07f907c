"""ServerExecute (paper Algorithm 1) — round builders and the two
multi-round drivers, port of ``repro.federated.server``.

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
  client over all its leaves). Memory is O(1) clients. A strategy whose
  aggregation is not Eq. 5 (FedADP) instead has its sequentially trained
  locals stacked and handed to its ``aggregate`` hook.

``FLConfig(compression=CompressionConfig(...))`` quantizes every uploaded
layer into int8 or int4 levels plus a per-unit scale, with optional
client-side error feedback: the vmap round then reduces the packed payload
through the fused uplink kernels (``strategy.uplink_round``), or through
the legacy unfused chain with ``CompressionConfig(fused=False)``. The scan
round refuses compression, as the reference's does.

Two multi-round drivers share those round functions:

- :func:`run_training` — the host loop: one Python iteration and one host
  pull a round. ``sampler="host"`` is the reference's numpy stream (one
  seed, the same clients and batches as the reference's host sampler);
  ``sampler="device"`` is the engine's keyed streams and device gather, so
  one seed gives :func:`run_training_scan`'s trajectory.
- :func:`run_training_scan` — the device-resident engine: the dataset
  lives on the device as :class:`~repro_torch.data.ClientShards`, a block
  of rounds (the rounds between two evaluations) issues device work only,
  with the block's draws copied to the device once at its start, and the
  per-round losses and cumulative uplink come back in one host pull a
  block. The reference's compiled ``lax.scan`` becomes a Python loop that
  enqueues; there is no CUDA graph and no compiled-callable cache yet
  (ROADMAP Queue 1).

Both drivers thread strategy state across rounds (the error-feedback
residual store, FedLAMA's intervals) and resume: ``start_round=<rounds
done>`` with ``server_state=<log.final_state>`` continues a run; with the
keyed streams (a pure function of the seed and the absolute round index)
the continuation is bit-identical to a run that never stopped.

Numerics: the round builders switch TF32 off for cuDNN convolutions and
CUDA matmuls (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``, process-wide). TF32, PyTorch's
default for convolutions, keeps about three decimal digits; the port holds
its rounds to the f32 reference, and Eq. 4 ranks the Eq. 3 values, so the
rounds run in full f32.

Trainable partitions (``FLConfig(partition=ParamPartition)``, e.g.
:func:`~repro_torch.models.lora.lora_partition` for adapter fine-tuning):
both drivers split the params once; the unit map, the strategy state, the
comm ledger and the EF residual store cover the trainable sub-tree only,
the frozen base is closed into every local step (``frozen=`` of the round
and block functions), and the drivers return ``partition.merge(trained,
frozen)`` with the frozen leaves the caller's own tensors. An
all-trainable partition gives the rounds of ``partition=None`` bit for
bit.

Telemetry (``FLConfig(telemetry=TelemetryConfig(...))``, see
:mod:`repro_torch.telemetry`): the round builders add ``metrics["taps"]``;
both drivers write the JSONL round ledger, report through the progress
sink, sample wall-clock and peak device memory, and open a
``torch.profiler`` window over ``profile_rounds``. The engine stacks a
block's comm, taps and selection on the device and pulls them with its
losses in the block's one pull. ``telemetry=None`` leaves every round,
block and printed line as it is without telemetry; with it on, the
trajectories are the same bit for bit (taps only read).

Spans (:func:`repro_torch.telemetry.profiling.span`, recorded only inside
``profiling.recording()``) mark where the engine (``engine.enter``,
``engine.draws``, ``engine.round``, ``engine.pull``, ``engine.exit``) and
the rounds (``round.local_training``, ``round.divergence``,
``round.select``, ``round.aggregate`` or ``round.uplink``,
``round.update_state``, ``round.taps``, the state's ``round.state_view``
and ``round.state_scatter``; the scan round's ``round.phase1``,
``round.phase2`` and ``round.finalize``) enqueue their work. Off, a span
is one flag check; on, it reads the clock and nothing on the device.

Both drivers scale past one device over a client mesh
(``FLConfig(mesh=make_client_mesh(D))``, :mod:`repro_torch.launch.mesh`):
one process (rank) a device, each running the same driver. Every rank
draws the same participants and batch indices from the keyed streams,
gathers and trains only its K/D rows, and the vmap round stitches the
round back together with ``torch.distributed`` collectives: the (K/D, U)
Eq. 3 blocks are all-gathered for the global top-n selection (the same on
every rank), and the Eq. 5 numerators and denominator, the loss sum and
the taps' client partials travel in ONE cross-rank sum over one flat f32
buffer (flat, or two-tier with ``agg_group_size``), after which every rank
divides, so every rank holds the same new model. The round's new EF rows
are all-gathered and scattered into every rank's N-row store. Comm bytes
come from the full selection, exactly as on one device.
``shard_samples=True`` keeps only the rank's affinity block of the dataset
on its device. Rank 0 alone writes the ledger, prints and profiles.

On the 2-D ``('clients', 'model')`` mesh (``make_client_mesh(D,
model=M)``, a grid of C = D/M client rows of M ranks) the client split is
over the C rows (the M ranks of a row train the same K/C clients), and
the params, the frozen base and every param-shaped client store (the EF
residuals) are held between rounds as the rank's 1/M shards
(:mod:`repro_torch.launch.sharding`, FSDP). A round all-gathers them over
the rank's row (one collective), trains and scores on the whole model,
and slices the Eq. 5 numerators back to the rank's shard before the one
cross-rank sum, which runs over the rank's column (the ranks of one shard
index). Gather and slice are exact, so a 2-D round is the 1-D mesh round
of C ranks bit for bit. Both drivers return the whole model on every rank
(gathered once at the end) and ``log.final_state`` as the rank's shards.

Not yet ported (ROADMAP Queue 1): the JAX-key sampler (item 7).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core.partition import ParamPartition, partition_counts
from repro_torch.core.units import (UnitMap, host_to_device, tree_leaves,
                                    tree_map, tree_stack_index,
                                    tree_unflatten)
from repro_torch.core.wire import CompressionConfig
from repro_torch.data.device import ClientShards
from repro_torch.federated.client import make_local_update
from repro_torch.federated.sampling import (KeyedDraws, local_rows,
                                            sample_clients)
from repro_torch.federated.strategies import (FedADPOptions, FedLAMAOptions,
                                              FedLPOptions, get_strategy_cls,
                                              make_strategy,
                                              registered_algos)
from repro_torch.launch.mesh import client_mesh_size, model_mesh_size
from repro_torch.launch.sharding import (fl_param_specs, tree_all_gather,
                                         tree_shard_slice)
from repro_torch.optim.opt import Optimizer, sgd
from repro_torch.telemetry import (ProgressSink, RoundLedger,
                                   TelemetryConfig)
from repro_torch.telemetry import profiling as prof_mod
from repro_torch.telemetry.profiling import span
from repro_torch.telemetry import taps as taps_mod

Pytree = Any


def __getattr__(name):   # PEP 562: ALGOS is a live view of the registry
    if name == "ALGOS":
        return registered_algos()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# deprecated flat FLConfig fields -> (owning algo, options field); the
# normalization shim in FLConfig.__post_init__ folds non-default values
# into algo_options and mirrors the normalized options back
_DEPRECATED_ALGO_FIELDS = (
    ("fedadp_keep", "fedadp", "keep"),
    ("fedlp_p", "fedlp", "p"),
    ("fedlama_tau", "fedlama", "tau"),
    ("fedlama_lam", "fedlama", "lam"),
)

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
    # per-strategy knobs: FedADPOptions | FedLPOptions | FedLAMAOptions |
    # a plugin strategy's declared options_cls. None resolves to the
    # strategy's defaults (or to the deprecated flat fields below).
    algo_options: Optional[Any] = None
    # uplink compression policy (repro_torch.core.wire.CompressionConfig):
    # packed quantized uploads + optional error feedback + divergence-driven
    # bit allocation (bits="auto"). None = f32 uploads.
    compression: Optional[CompressionConfig] = None
    # trainable/frozen split (repro_torch.core.partition.ParamPartition):
    # only the trainable sub-tree is trained, divergence-scored,
    # communicated and aggregated; the frozen base stays on the device and
    # is closed over by local training. None = every leaf trainable.
    partition: Optional[ParamPartition] = None
    batch_per_client: int = 32
    # the reference's jax.checkpoint around each local step; accepted and
    # changes nothing (see federated.client.make_local_update)
    remat: bool = False
    # ---- deprecated flat knobs (warn and fold into algo_options /
    # compression; kept as mirrors of the normalized values) ----
    fedadp_keep: float = 0.2       # FedADP keep fraction
    fedlp_p: float = 0.5           # FedLP per-layer keep probability
    fedlama_tau: int = 2           # FedLAMA base aggregation interval τ'
    fedlama_lam: int = 2           # FedLAMA long-interval multiplier λ
    quantize_bits: int = 0         # quantized delta upload (0 = off)
    error_feedback: bool = False
    # multi-device: split the round's K clients over this client mesh
    # (repro_torch.launch.mesh.make_client_mesh; one rank a device). None
    # = the one-device round.
    mesh: Optional[Any] = None
    # two-tier aggregation (mesh only): the round's one cross-rank sum
    # becomes an all-reduce within blocks of agg_group_size consecutive
    # ranks, then a ring across the blocks (core.aggregation.
    # hierarchical_psum). 0 (default) keeps one flat all-reduce; 1 is a
    # pure ring over all ranks.
    agg_group_size: int = 0
    # sample-axis sharding (mesh only): the drivers place ClientShards
    # with shard_samples=True, each rank holding only its affinity block
    # of the samples (about 1/D of the bytes), and draw the cohort per
    # affinity group
    shard_samples: bool = False
    # observability: metric taps + JSONL round ledger + profiling hooks
    # (see repro_torch.telemetry). None (default) is the zero-cost path:
    # rounds, blocks and fixed-seed trajectories are bit-identical to a
    # config without telemetry.
    telemetry: Optional[TelemetryConfig] = None

    # ------------------------------------------------------------------
    def _normalize_algo_options(self, scls):
        """Fold the deprecated flat per-algo knobs into ``algo_options``
        (validated by the owning options classes) and mirror the
        normalized options back onto the flat names, so equivalent
        spellings compare equal."""
        defaults = {f.name: f.default
                    for f in dataclasses.fields(type(self))}
        flat_set = [name for name, _, _ in _DEPRECATED_ALGO_FIELDS
                    if getattr(self, name) != defaults[name]]
        # the flat values are validated whatever the algo: constructing
        # the options classes raises ValueError on bad values
        legacy = {
            "fedadp": FedADPOptions(keep=self.fedadp_keep),
            "fedlp": FedLPOptions(p=self.fedlp_p),
            "fedlama": FedLAMAOptions(tau=self.fedlama_tau,
                                      lam=self.fedlama_lam),
        }
        opts = self.algo_options
        if opts is not None:
            ocls = getattr(scls, "options_cls", None)
            if ocls is None:
                raise TypeError(
                    f"strategy {self.algo!r} declares no options class; "
                    f"got algo_options={opts!r}")
            if not isinstance(opts, ocls):
                raise TypeError(
                    f"algo_options for strategy {self.algo!r} must be "
                    f"{ocls.__name__}, got {type(opts).__name__}")
            # a flat field that disagrees with the options instance is a
            # conflict; agreeing values (the mirrors dataclasses.replace
            # round-trips) are fine
            for name, algo, field in _DEPRECATED_ALGO_FIELDS:
                if algo != self.algo or name not in flat_set:
                    continue
                if getattr(self, name) != getattr(opts, field):
                    raise ValueError(
                        f"FLConfig.{name}={getattr(self, name)} conflicts "
                        f"with algo_options.{field}="
                        f"{getattr(opts, field)}; pass one spelling, "
                        "not both")
        else:
            if flat_set:
                warnings.warn(
                    f"FLConfig fields {flat_set} are deprecated; pass "
                    "algo_options=FedADPOptions/FedLPOptions/"
                    "FedLAMAOptions(...) instead",
                    DeprecationWarning, stacklevel=3)
            opts = legacy.get(self.algo)
            if opts is None and getattr(scls, "options_cls", None):
                opts = scls.options_cls()
            object.__setattr__(self, "algo_options", opts)
        for name, algo, field in _DEPRECATED_ALGO_FIELDS:
            if algo == self.algo and opts is not None:
                object.__setattr__(self, name, getattr(opts, field))

    def _normalize_compression(self, scls):
        """Fold the deprecated ``quantize_bits``/``error_feedback`` flats
        into ``compression`` and mirror back."""
        comp = self.compression
        if comp is not None:
            if not isinstance(comp, CompressionConfig):
                raise TypeError(
                    "FLConfig.compression must be a repro_torch.core.wire."
                    f"CompressionConfig or None, got {type(comp)}")
            # disagreement (not mere presence) is the conflict, so the
            # mirrored flats survive dataclasses.replace round-trips
            mirror_qb = 0 if comp.is_auto else int(comp.bits)
            if self.quantize_bits not in (0, mirror_qb) or \
                    (self.error_feedback and not comp.error_feedback):
                raise ValueError(
                    "FLConfig.quantize_bits/error_feedback conflict with "
                    "compression=CompressionConfig(...); pass one "
                    "spelling, not both")
        else:
            if self.error_feedback and not self.quantize_bits > 0:
                # the reference asserts here; same exception type
                raise AssertionError("error feedback needs quantization")
            if self.quantize_bits:
                warnings.warn(
                    "FLConfig(quantize_bits=..., error_feedback=...) is "
                    "deprecated; pass compression=CompressionConfig("
                    "bits=..., error_feedback=...) instead",
                    DeprecationWarning, stacklevel=3)
                comp = CompressionConfig(
                    bits=int(self.quantize_bits),
                    error_feedback=self.error_feedback)
                object.__setattr__(self, "compression", comp)
        if comp is not None:
            # mirror: the flat int shows the effective width (0 for the
            # adaptive allocator, whose width is per-round)
            object.__setattr__(self, "quantize_bits",
                               0 if comp.is_auto else int(comp.bits))
            object.__setattr__(self, "error_feedback", comp.error_feedback)
        if comp is not None and not scls.supports_quantize:
            raise ValueError(
                f"strategy {self.algo!r} declares supports_quantize=False "
                "(fedadp aggregates pruned neurons, not quantized deltas)")

    def __post_init__(self):
        # unknown algos raise ValueError listing the registered names;
        # capability flags replace engine special cases
        scls = get_strategy_cls(self.algo)
        if self.mode not in ("vmap", "scan"):
            raise ValueError(f"FLConfig.mode must be 'vmap' or 'scan', got "
                             f"{self.mode!r}")
        if not 1 <= self.top_n <= self.clients_per_round:
            raise ValueError(f"top_n={self.top_n} out of range for "
                             f"K={self.clients_per_round}")
        self._normalize_algo_options(scls)
        self._normalize_compression(scls)
        if self.mode == "scan":
            if not scls.supports_scan:
                raise ValueError(
                    f"strategy {self.algo!r} declares supports_scan=False")
            if self.compression is not None:
                raise NotImplementedError(_SCAN_COMPRESSION_MSG)
        if self.partition is not None and \
                not isinstance(self.partition, ParamPartition):
            raise TypeError(
                "FLConfig.partition must be a repro_torch.core.partition."
                f"ParamPartition or None, got {type(self.partition)}")
        if self.mesh is not None:
            # the reference asserts the first and third; same exception
            if self.mode != "vmap":
                raise AssertionError(
                    "client-axis sharding needs stacked clients "
                    "(mode='vmap')")
            if not scls.supports_mesh:
                raise ValueError(
                    f"strategy {self.algo!r} declares supports_mesh=False "
                    "(a declared capability — see "
                    "repro_torch.federated.strategies)")
            d = client_mesh_size(self.mesh)
            if self.clients_per_round % d:
                raise AssertionError(
                    f"K={self.clients_per_round} must divide over {d} "
                    "devices")
            if self.agg_group_size:
                gs = self.agg_group_size
                if not (1 <= gs <= d and d % gs == 0):
                    raise ValueError(
                        f"FLConfig.agg_group_size={gs} must be in [1, {d}] "
                        f"and divide the 'clients' axis size {d}")
            if self.shard_samples and self.num_clients % d:
                raise ValueError(
                    f"FLConfig.shard_samples needs N={self.num_clients} "
                    f"divisible by the {d} 'clients'-axis devices (the "
                    "static client→device affinity assigns N/D clients "
                    "per device)")
        else:
            if self.agg_group_size:
                raise ValueError(
                    "FLConfig.agg_group_size is a mesh-round knob; pass "
                    "mesh=make_client_mesh(...) too")
            if self.shard_samples:
                raise ValueError(
                    "FLConfig.shard_samples is a mesh-round knob; pass "
                    "mesh=make_client_mesh(...) too")
        if self.telemetry is not None and \
                not isinstance(self.telemetry, TelemetryConfig):
            raise TypeError(
                "FLConfig.telemetry must be a repro_torch.telemetry."
                f"TelemetryConfig or None, got {type(self.telemetry)}")


def _full_fp32() -> None:
    """Full-f32 convolutions and matmuls on the card (see module doc)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ======================================================================
# Round builders
# ======================================================================
def build_round_vmap(loss_fn, umap: UnitMap, flcfg: FLConfig,
                     opt: Optimizer | None = None, *,
                     layout: Optional["ModelLayout"] = None):
    """Round function with parallel (stacked) clients:
    ``round_fn(params, batch, data_sizes, state=None, uniform=None) ->
    (new_params, metrics)`` with batch leaves ``(K, B, ...)`` and
    ``metrics`` holding ``loss``, ``comm``, ``selection``, ``divergence``
    (the (K, U) Eq. 3 matrix, or None), ``wire`` (the packed payload's
    accounting, or None), when a ``state`` is given the updated ``state``,
    and with ``flcfg.telemetry.taps`` the round's ``taps``
    (:func:`repro_torch.telemetry.taps.collect`; a packed round adds
    ``wire_unit_bytes`` and ``wire_bits``). ``uniform(shape)`` is the
    round's algorithm stream (the reference's per-round key), which the
    random policies draw from.

    With error feedback ``state`` is required: its client entry
    ``"residual"`` holds the participants' (K, ...) residual rows (see
    :func:`run_training`). With ``flcfg.partition``, ``params`` is the
    trainable sub-tree and ``frozen`` the frozen base, which every
    client's local step closes over.

    With ``flcfg.mesh`` the round is this rank's share of the client-
    sharded round (:func:`_build_round_vmap_sharded`): ``batch``,
    ``data_sizes`` and the state's client rows are the rank's K/C rows,
    and every metric, and the state's client rows, come back for all K.
    On a 2-D mesh ``layout`` (:class:`ModelLayout`) is required: ``params``,
    ``frozen`` and the state come in and go out as the rank's shards."""
    _full_fp32()
    local_update = _local_update(loss_fn, flcfg, opt)
    strategy = make_strategy(flcfg)
    if flcfg.mesh is not None:
        return _build_round_vmap_sharded(local_update, umap, flcfg,
                                         strategy, layout)
    k = flcfg.clients_per_round
    taps_on = _taps_on(flcfg)

    def round_fn(params: Pytree, batch: dict, data_sizes: torch.Tensor,
                 state: Optional[dict] = None, uniform=None,
                 frozen: Optional[Pytree] = None):
        with span("round.local_training"):
            locals_, losses = torch.func.vmap(
                _with_frozen(local_update, frozen), in_dims=(None, 0))(
                    params, batch)
        # Eq. 3 on the client-stacked locals: one call over every leaf
        divs = None
        if strategy.needs_divergence:
            with span("round.divergence"):
                divs = umap.divergence(locals_, params)
        with span("round.select"):
            selection = strategy.select_with_state(
                state, divs, uniform, k, umap.num_units, flcfg.top_n,
                data_sizes.device)
        res_rows = _residual_rows(strategy, state)

        wire = None
        if strategy.packed_upload:
            # packed wire-format uplink: the strategy quantizes the client
            # deltas into PackedPayload buffers and reduces them through
            # the fused uplink kernels: one launch a round over every
            # leaf, or one a leaf with error feedback
            with span("round.uplink"):
                new_params, new_rows, wire = strategy.uplink_round(
                    locals_, params, umap, selection, divs, data_sizes,
                    res_rows)
                comm = strategy.comm_profile(
                    selection, umap, unit_bytes_override=wire["unit_bytes"])
        else:
            with span("round.aggregate"):
                uploads, new_rows = _transform_uploads(
                    strategy, locals_, params, umap, res_rows, selection)
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
            with span("round.update_state"):
                metrics["state"] = strategy.update_state(
                    state, selection, divs, umap, uniform=uniform)
        if taps_on:
            # client rows in the post-update_state view hold the updated
            # residuals (update_state keeps entries it does not own)
            with span("round.taps"):
                metrics["taps"] = taps_mod.collect(
                    strategy, metrics.get("state"), selection, divs, umap,
                    extra=(None if wire is None else
                           {"wire_unit_bytes": wire["unit_bytes"],
                            "wire_bits": wire["bits"]}))
        return new_params, metrics

    return round_fn


def build_round_scan(loss_fn, umap: UnitMap, flcfg: FLConfig,
                     opt: Optimizer | None = None):
    """Round function with sequential clients + two-phase recompute; same
    signature and metrics as :func:`build_round_vmap`.

    Memory (``eq5_weighted`` strategies): O(global + 1 local + 1
    accumulator) models, independent of K — selected layers are streamed
    into the Eq. 5 accumulator as each client trains. A strategy whose
    aggregation is not an Eq. 5 weighted mean (FedADP's element-wise neuron
    masks) instead has its sequentially trained locals stacked and fed to
    the same :meth:`FLStrategy.aggregate` hook as in vmap mode: O(K)
    parameter memory, still O(1) activation memory.
    """
    if flcfg.compression is not None:
        raise NotImplementedError(_SCAN_COMPRESSION_MSG)
    _full_fp32()
    strategy = make_strategy(flcfg)
    if not strategy.supports_scan:
        raise NotImplementedError(
            f"strategy {strategy.name!r} declares supports_scan=False")
    update = _local_update(loss_fn, flcfg, opt)
    k = flcfg.clients_per_round
    taps_on = _taps_on(flcfg)

    def round_fn(params: Pytree, batch: dict, data_sizes: torch.Tensor,
                 state: Optional[dict] = None, uniform=None,
                 frozen: Optional[Pytree] = None):
        local_update = _with_frozen(update, frozen)
        client_batches = [{name: v[i] for name, v in batch.items()}
                          for i in range(k)]
        # ---- phase 1: divergence feedback (only if the policy needs it)
        divs = losses1 = None
        if strategy.needs_divergence:
            with span("round.phase1"):
                rows, losses1 = [], []
                for batch_k in client_batches:
                    local, loss = local_update(params, batch_k)
                    with span("round.divergence"):
                        rows.append(umap.divergence(local, params))
                    losses1.append(loss)
                divs, losses1 = torch.stack(rows), torch.stack(losses1)

        with span("round.select"):
            selection = strategy.select_with_state(
                state, divs, uniform, k, umap.num_units, flcfg.top_n,
                data_sizes.device)

        losses2 = []
        if strategy.eq5_weighted:
            # ---- phase 2: recompute local training, stream layers in
            with span("round.phase2"):
                w, denom = agg.unit_weights(selection, data_sizes)
                frac = w / torch.where(
                    denom > 0, denom, torch.ones_like(denom))[None, :]  # (K,U)
                acc = agg.streaming_init(params)
                for batch_k, frac_k in zip(client_batches, frac):
                    local, loss = local_update(params, batch_k)
                    with span("round.aggregate"):
                        agg.streaming_add(acc, local, umap, frac_k)
                    losses2.append(loss)
            with span("round.finalize"):
                new_params = agg.streaming_finalize(acc, umap, denom,
                                                    params)
        else:
            # ---- phase 2 (not Eq. 5, e.g. FedADP): train one after
            # another, stack the locals, and call the same stacked-clients
            # aggregate hook as the vmap round
            with span("round.phase2"):
                locals_ = []
                for batch_k in client_batches:
                    local, loss = local_update(params, batch_k)
                    locals_.append(local)
                    losses2.append(loss)
            with span("round.aggregate"):
                stacked = tree_map(lambda *ls: torch.stack(ls), *locals_)
                new_params = strategy.aggregate(stacked, umap, selection,
                                                data_sizes, params)

        loss = (losses1 if losses1 is not None
                else torch.stack(losses2)).mean()
        metrics = {"loss": loss,
                   "comm": strategy.comm_profile(selection, umap),
                   "selection": selection, "divergence": divs}
        if state is not None:
            with span("round.update_state"):
                metrics["state"] = strategy.update_state(
                    state, selection, divs, umap, uniform=uniform)
        if taps_on:
            with span("round.taps"):
                metrics["taps"] = taps_mod.collect(
                    strategy, metrics.get("state"), selection, divs, umap)
        return new_params, metrics

    return round_fn


def _residual_rows(strategy, state: Optional[dict]):
    """The round's EF residual rows, when the strategy tracks them."""
    if not strategy.tracks_residuals:
        return None
    if state is None:
        raise ValueError(
            "error feedback needs the participants' residual rows: pass "
            "state=strategy.init_state(...) rows (run_training does)")
    return state["client"]["residual"]


def _transform_uploads(strategy, locals_: Pytree, params: Pytree,
                       umap: UnitMap, res_rows, selection: torch.Tensor):
    """``(uploads, new_res_rows)`` of the stacked ``locals_`` (the
    selection's rows are theirs): the identity, or the upload transform
    client by client (e.g. quantized deltas: the server reconstructs
    Ĝ + dequant(Q(Δ + e))), with the error-feedback residuals advanced only
    where a layer was uploaded."""
    if not strategy.transforms_upload:
        return locals_, None
    k = selection.shape[0]
    outs = [strategy.transform_upload(
        tree_stack_index(locals_, i), params, umap,
        None if res_rows is None else tree_stack_index(res_rows, i))
        for i in range(k)]
    uploads = tree_map(lambda *ls: torch.stack(ls), *(o[0] for o in outs))
    new_rows = None
    if strategy.tracks_residuals:
        rows = [strategy.update_residual(
            outs[i][1], tree_stack_index(res_rows, i), selection[i], umap,
            params) for i in range(k)]
        new_rows = tree_map(lambda *ls: torch.stack(ls), *rows)
    return uploads, new_rows


def _build_round_vmap_sharded(local_update, umap: UnitMap, flcfg: FLConfig,
                              strategy, layout: Optional["ModelLayout"]):
    """This rank's share of the client-sharded vmap round, port of the
    reference's ``shard_map`` body: each of the mesh's D ranks trains its
    K/D clients, and one ``torch.distributed`` call stands for each
    collective of the reference's body:

    - Eq. 3: the rank's (K/D, U) divergence block (one ``sqdiff_rowsum``
      call) is all-gathered into the (K, U) matrix, so the top-n selection
      (Eq. 4), which needs every client's divergences, is computed alike
      on every rank (as are the random policies' draws: the algorithm
      stream is the same on every rank); each rank keeps its own rows.
    - Eq. 5, the loss sum and the taps' client partials travel in ONE
      cross-rank sum of one flat f32 buffer: the additive halves of the
      strategy's aggregation (``psum_parts``, or ``uplink_psum_parts``
      through the fused uplink kernels over the rank's rows), then the
      division on every rank (``psum_finalize``). ``agg_group_size``
      makes it two-tier (:func:`~repro_torch.core.aggregation.
      hierarchical_psum`).
    - Comm bytes are priced from the full selection (and the packed
      wire's per-unit bytes, alike on every rank), so they are exactly the
      one-device round's; the aggregation tiers' bytes
      (:func:`~repro_torch.core.comm.agg_tier_bytes`) are added after.
    - State: global entries enter and leave replicated (the transition
      runs on the same inputs on every rank); client entries enter as the
      rank's rows, and the round's new rows are all-gathered (one
      collective) so the drivers write the same K rows into every rank's
      N-row store.

    On a 2-D mesh (C client rows of M ranks) the "ranks" above are the C
    client coordinates, and every clients-axis collective runs within the
    rank's column. ``params``, ``frozen`` and the state's param-shaped
    client rows come in as the rank's 1/M shards (``layout``'s specs):
    one all-gather over the rank's row gives the whole model, the frozen
    base and the rows for training, Eq. 3 and the uplink kernel; the Eq. 5
    numerators (and a param-shaped denominator, FedADP's) are sliced back
    to the shard before the sum, which divides on the shard; the state
    goes back to shards before its rows are all-gathered. The taps' client
    partials come from the whole rows, so the column's sum is the whole
    norm. The aggregation tiers are priced at 1/M of the model, as the
    reference's (the replicated 1-D leaves are not subtracted).
    """
    mesh = flcfg.mesh
    mesh.check_member()
    d = client_mesh_size(mesh)
    m = model_mesh_size(mesh)
    if m > 1 and layout is None:
        raise ValueError(
            "a round on a 2-D ('clients', 'model') mesh needs the run's "
            "ModelLayout (the drivers build it: run_training, "
            "run_training_scan)")
    k = flcfg.clients_per_round
    kloc = k // d
    taps_on = _taps_on(flcfg)
    gs = flcfg.agg_group_size
    hier = bool(gs) and gs < d
    tier_bytes = comm_mod.agg_tier_bytes(umap.total_bytes / m, d,
                                         gs if hier else 0)

    def round_fn(params: Pytree, batch: dict, data_sizes: torch.Tensor,
                 state: Optional[dict] = None, uniform=None,
                 frozen: Optional[Pytree] = None):
        shard = params
        if m > 1:
            params, frozen, state = layout.gather(params, frozen, state)
        with span("round.local_training"):
            locals_, losses = torch.func.vmap(
                _with_frozen(local_update, frozen), in_dims=(None, 0))(
                    params, batch)
        divs = None
        if strategy.needs_divergence:
            with span("round.divergence"):
                divs = mesh.all_gather_rows(umap.divergence(locals_, params))
        dev = data_sizes.device
        with span("round.select"):
            selection = strategy.select_with_state(
                state, divs, uniform, k, umap.num_units, flcfg.top_n, dev)
        sel_loc = local_rows(selection, mesh.client_rank, kloc)
        res_rows = _residual_rows(strategy, state)

        wire = None
        # the additive halves, the one cross-rank sum and the division
        with span("round.uplink" if strategy.packed_upload
                  else "round.aggregate"):
            if strategy.packed_upload:
                parts, denom_loc, new_rows, wire = \
                    strategy.uplink_psum_parts(locals_, params, umap,
                                               sel_loc, divs, data_sizes,
                                               res_rows)
                comm = strategy.comm_profile(
                    selection, umap, unit_bytes_override=wire["unit_bytes"])
            else:
                uploads, new_rows = _transform_uploads(
                    strategy, locals_, params, umap, res_rows, sel_loc)
                parts, denom_loc = strategy.psum_parts(
                    uploads, umap, sel_loc, data_sizes, global_params=params)
                comm = strategy.comm_profile(selection, umap)
            if strategy.tracks_residuals:
                state = {**state, "client": {**state["client"],
                                             "residual": new_rows}}
            if m > 1:
                parts, denom_loc = layout.slice_parts(parts, denom_loc)
            # the taps' client-state partials (the rank's rows) ride the
            # same sum: taps add no collective
            client_sq = {}
            if taps_on and state is not None and state.get("client"):
                client_sq = taps_mod.client_sqsums(state["client"])
            sums = agg.mesh_psum({"parts": parts, "denom": denom_loc,
                                  "loss": losses.sum(),
                                  "client_sq": client_sq},
                                 mesh, gs if hier else 0)
            new_params = strategy.psum_finalize(sums["parts"], sums["denom"],
                                                umap, shard, shard)
        for name, v in tier_bytes.items():
            comm[name] = torch.full((), v, dtype=torch.float32, device=dev)
        metrics = {"loss": sums["loss"] / k, "comm": comm,
                   "selection": selection, "divergence": divs,
                   "wire": wire}
        if state is not None:
            with span("round.update_state"):
                state = strategy.update_state(state, selection, divs, umap,
                                              uniform=uniform)
                if m > 1:
                    state = layout.slice_state(state)
                metrics["state"] = _gather_client_rows(state, mesh)
        if taps_on:
            # the client norms from the summed partials ({} without
            # client state), never from the gathered rows
            with span("round.taps"):
                metrics["taps"] = taps_mod.collect(
                    strategy, metrics.get("state"), selection, divs, umap,
                    client_sq=sums["client_sq"],
                    extra=(None if wire is None else
                           {"wire_unit_bytes": wire["unit_bytes"],
                            "wire_bits": wire["bits"]}))
        return new_params, metrics

    return round_fn


def _gather_client_rows(state: dict, mesh) -> dict:
    """The state with every client entry's (K/C, ...) rows all-gathered
    into the round's (K, ...) rows, in client-coordinate order: one
    collective over one buffer of every such leaf, each leaf's dtype kept
    (a cast to f32 and back is exact for f32, bf16 and f16)."""
    names = list(state.get("client") or {})
    if not names:
        return state
    leaves = [l for n_ in names for l in tree_leaves(state["client"][n_])]
    kloc = leaves[0].shape[0]
    widths = [l[0].numel() for l in leaves]
    buf = torch.cat([l.reshape(kloc, -1).float() for l in leaves], dim=1)
    full = mesh.all_gather_rows(buf).split(widths, dim=1)
    rows = iter(f.reshape((-1,) + tuple(l.shape[1:])).to(l.dtype)
                for f, l in zip(full, leaves))
    client = dict(state["client"])
    for n_ in names:
        client[n_] = tree_unflatten(state["client"][n_], rows)
    return {**state, "client": client}


def _taps_on(flcfg: FLConfig) -> bool:
    return flcfg.telemetry is not None and flcfg.telemetry.taps


def _local_update(loss_fn, flcfg: FLConfig, opt: Optimizer | None):
    return make_local_update(loss_fn, opt or sgd(flcfg.lr),
                             flcfg.local_steps, remat=flcfg.remat,
                             partition=flcfg.partition)


def _with_frozen(local_update, frozen: Optional[Pytree]):
    """``local_update(params, batch)``, with the frozen base closed in
    when the round has one."""
    if frozen is None:
        return local_update
    return lambda p, b: local_update(p, b, frozen)


def build_round_fn(loss_fn, umap: UnitMap, flcfg: FLConfig,
                   opt: Optimizer | None = None, *,
                   layout: Optional["ModelLayout"] = None):
    if flcfg.mode == "vmap":
        return build_round_vmap(loss_fn, umap, flcfg, opt, layout=layout)
    return build_round_scan(loss_fn, umap, flcfg, opt)


# ======================================================================
# Multi-round drivers
# ======================================================================
@dataclasses.dataclass
class TrainLog:
    rounds: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    test_errors: list = dataclasses.field(default_factory=list)
    uplink_mb: list = dataclasses.field(default_factory=list)
    meter: comm_mod.CommMeter = dataclasses.field(
        default_factory=comm_mod.CommMeter)
    # strategy state after the last round (None for stateless strategies);
    # feed it back as run_training*(server_state=...) with
    # start_round=<rounds done> to continue a run (checkpoint it with
    # repro_torch.checkpoint.save_server_state)
    final_state: Optional[dict] = None


# Strategy state is ``{"client": {name: (N, ...) store}, "global": {name:
# tree}}`` or None (see FLStrategy.init_state). The helpers below are the
# only state plumbing the drivers need; the EF residual store is just the
# client entry named "residual" that the quantize wrapper declares.
def _scatter_rows(store: Pytree, clients: torch.Tensor,
                  rows: Pytree) -> Pytree:
    """Write the participants' rows back into the (N, ...) store **in
    place** (the driver owns the store: it copies a caller's
    ``server_state`` once at entry; a functional copy would move the whole
    N × model store every round). The explicit cast keeps each leaf's own
    dtype: the EF arithmetic runs in f32."""
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


def _same_structure(a: Pytree, b: Pytree) -> bool:
    return tree_map(lambda _: None, a) == tree_map(lambda _: None, b)


def _shift(specs: Pytree) -> Pytree:
    """Specs of client rows: a leading client axis the specs do not name."""
    return tree_map(lambda s: (None,) + s, specs)


@dataclasses.dataclass(frozen=True)
class ModelLayout:
    """A run's placement over the 'model' axis of a 2-D mesh (the in and
    out specs of the reference's ``shard_map`` body): the
    :func:`~repro_torch.launch.sharding.fl_param_specs` of the trainable
    params and of the frozen base (None without a partition), and the
    strategy's ``state_specs`` (None when stateless). The drivers build
    it once (:meth:`of`) and cut the run's trees to this rank's shards
    (:meth:`shard`); the round gathers them whole (:meth:`gather`) and
    cuts back (:meth:`slice_parts`, :meth:`slice_state`)."""

    mesh: Any
    params: Pytree
    frozen: Optional[Pytree]
    state: Optional[dict]

    @classmethod
    def of(cls, flcfg: FLConfig, strategy, params: Pytree,
           frozen: Optional[Pytree],
           state: Optional[dict]) -> Optional["ModelLayout"]:
        """The layout of whole ``params`` and ``frozen`` and the run's
        ``state`` on ``flcfg.mesh``; None off a 2-D mesh."""
        mesh = flcfg.mesh
        if mesh is None or model_mesh_size(mesh) == 1:
            return None
        return cls(mesh, fl_param_specs(params, mesh),
                   None if frozen is None else fl_param_specs(frozen, mesh),
                   None if state is None else
                   strategy.state_specs(params, state, mesh))

    def _cut(self, tree: Pytree, specs: Pytree, offset: int = 0) -> Pytree:
        return tree_shard_slice(tree, specs, self.mesh.model_size,
                                self.mesh.model_rank, offset)

    def _state_specs(self, state: dict) -> dict:
        """Specs of a round's state view: client rows shifted by their
        client axis."""
        return {kind: {n_: (_shift(self.state[kind][n_]) if kind == "client"
                            else self.state[kind][n_])
                       for n_ in state[kind]}
                for kind in ("client", "global") if state.get(kind)}

    def shard(self, params: Pytree, frozen: Optional[Pytree],
              state: Optional[dict]):
        """This rank's shards of whole ``params`` and ``frozen``, and the
        run's state with every whole param-shaped client store cut to its
        shard (a store created sharded, or a ``final_state`` of this grid,
        is kept as it is; global entries are kept as they are)."""
        whole = tree_map(lambda l: tuple(l.shape), params)
        if state is not None and state.get("client"):
            client = {}
            for n_, e in state["client"].items():
                specs = self.state["client"][n_]
                if _same_structure(e, params) and all(
                        tuple(l.shape[1:]) == w for l, w in
                        zip(tree_leaves(e), tree_leaves(whole))):
                    e = self._cut(e, specs, 1)
                client[n_] = e
            state = {**state, "client": client}
        return (self._cut(params, self.params),
                None if frozen is None else self._cut(frozen, self.frozen),
                state)

    def gather(self, params: Pytree, frozen: Optional[Pytree],
               state: Optional[dict]):
        """The whole params, frozen base and state rows from this rank's
        shards: ONE all-gather over the rank's model row."""
        tree, specs = {"params": params}, {"params": self.params}
        if frozen is not None:
            tree["frozen"], specs["frozen"] = frozen, self.frozen
        if state is not None:
            st_specs = self._state_specs(state)
            tree["state"] = {kind: state[kind] for kind in st_specs}
            specs["state"] = st_specs
        full = tree_all_gather(tree, specs, self.mesh)
        if state is not None:
            state = {**state, **full["state"]}
        return full["params"], full.get("frozen"), state

    def slice_parts(self, parts: Pytree, denom: Pytree):
        """Eq. 5 numerators (and a param-structured denominator, FedADP's
        element-wise counts; the (U,) one stays whole) cut to this rank's
        shard."""
        if isinstance(denom, dict) and _same_structure(denom, parts):
            denom = self._cut(denom, self.params)
        return self._cut(parts, self.params), denom

    def slice_state(self, state: dict) -> dict:
        """A round's whole state view cut back to this rank's shards."""
        st_specs = self._state_specs(state)
        return {**state, **{kind: self._cut(state[kind], st_specs[kind])
                            for kind in st_specs}}


def _initial_state(strategy, params: Pytree, flcfg: FLConfig,
                   server_state: Optional[dict], device) -> Optional[dict]:
    """The state the first round sees: ``server_state`` copied once onto
    ``device`` (the drivers write client rows in place, and must not
    change a caller's tensors, e.g. a checkpoint still held), or the
    strategy's fresh ``init_state``."""
    if server_state is None:
        return strategy.init_state(params, flcfg.num_clients, flcfg.mesh)
    return tree_map(lambda l: torch.as_tensor(l).to(device, copy=True),
                    server_state)


def _step(round_fn, params: Pytree, state: Optional[dict], batch: dict,
          sizes: torch.Tensor, clients: torch.Tensor, rd, device,
          frozen: Optional[Pytree] = None, rows: slice = slice(None)):
    """One round of either driver: the participants' state rows in, the
    round, the rows scattered back; ``rd`` gives the algorithm stream.
    ``rows`` are this rank's rows of the K participants on a mesh (the
    round takes those state rows and gives back all K)."""
    uniform = _round_uniform(rd, device)
    if state is None:
        params, metrics = round_fn(params, batch, sizes, uniform=uniform,
                                   frozen=frozen)
        return params, None, metrics
    with span("round.state_view"):
        view = _state_round_view(state, clients[rows])
    params, metrics = round_fn(params, batch, sizes, view, uniform,
                               frozen=frozen)
    with span("round.state_scatter"):
        state = _state_scatter(state, metrics["state"], clients)
    return params, state, metrics


def _rank_rows(flcfg: FLConfig) -> slice:
    """This rank's rows of a round's K participants: all of them off the
    mesh, ``[c·K/C, (c+1)·K/C)`` at client coordinate c of C."""
    mesh = flcfg.mesh
    if mesh is None:
        return slice(None)
    kloc = flcfg.clients_per_round // client_mesh_size(mesh)
    return slice(mesh.client_rank * kloc, (mesh.client_rank + 1) * kloc)


def _check_rank_clients(flcfg: FLConfig, clients: torch.Tensor,
                        rows: slice) -> None:
    """Under sample sharding a rank holds its affinity group's samples
    only: refuse a cohort (``clients``, on the host, (..., K)) whose rows
    for this rank lie outside its group (a ``draws`` not drawn per group)."""
    mesh = flcfg.mesh
    if not flcfg.shard_samples or client_mesh_size(mesh) <= 1:
        return
    cpg = flcfg.num_clients // client_mesh_size(mesh)
    c = mesh.client_rank
    if not bool((clients[..., rows] // cpg == c).all()):
        raise ValueError(
            f"shard_samples: client row {c}'s participants "
            f"{clients[..., rows].tolist()} are not all in its affinity "
            f"group [{c * cpg}, {(c + 1) * cpg}); draw the cohort per group "
            "(RoundDraws.clients(N, K, num_groups))")


def _device_of(device, flcfg: FLConfig) -> torch.device:
    """The device a run is on: ``device``, or on a mesh the mesh's (this
    rank's card), which must be of ``device``'s type."""
    device = torch.device(device)
    mesh = flcfg.mesh
    if mesh is None:
        return device
    mesh.check_member()
    if device.type != mesh.device.type:
        raise ValueError(f"device={device} but the mesh runs on "
                         f"{mesh.device}; pass device={mesh.device.type!r}")
    return mesh.device


def _round_uniform(rd, device) -> Callable:
    """The round's algorithm stream on ``device``: ``rd.uniform`` draws on
    the CPU, and the copy goes through pinned memory (no sync)."""
    def uniform(shape):
        return host_to_device(rd.uniform(shape).float(), device)
    return uniform


def _split(params: Pytree, flcfg: FLConfig):
    """``(trainable, frozen, partition_info)``: the params split once by
    ``flcfg.partition`` (``frozen`` None without one) and the partition's
    trainable/frozen totals for the ledger header (None without one)."""
    partition = flcfg.partition
    if partition is None:
        return params, None, None
    info = partition_counts(partition, params)
    trainable, frozen = partition.split(params)
    return trainable, frozen, info


def _place(strategy, params: Pytree, frozen: Optional[Pytree],
           flcfg: FLConfig, server_state: Optional[dict], device):
    """``(params, frozen, state, layout)`` of a run: the initial state
    (:func:`_initial_state`) and, on a 2-D mesh, the run's
    :class:`ModelLayout` with the params, the frozen base and the state's
    param-shaped stores cut to this rank's shards (``layout`` None
    elsewhere, where every tree stays whole)."""
    state = _initial_state(strategy, params, flcfg, server_state, device)
    layout = ModelLayout.of(flcfg, strategy, params, frozen, state)
    if layout is not None:
        params, frozen, state = layout.shard(params, frozen, state)
    return params, frozen, state, layout


def _whole(params: Pytree, frozen: Optional[Pytree], flcfg: FLConfig,
           layout: Optional[ModelLayout]) -> Pytree:
    """The full model of the run's trainable leaves and frozen base
    (gathered whole over the rank's row on a 2-D mesh, a collective)."""
    if layout is not None:
        params, frozen, _ = layout.gather(params, frozen, None)
    if flcfg.partition is None:
        return params
    return flcfg.partition.merge(params, frozen)


def _run_meta(flcfg: FLConfig, *, driver: str, umap: UnitMap, seed: int,
              sampler: str, start_round: int, rounds: int, run_id: str,
              partition_info: Optional[dict] = None) -> dict:
    """Ledger run-header metadata, the reference's key set: everything a
    consumer needs to label a segment without rebuilding the model (the
    layer-unit names index every per-layer tap vector; under a partition
    they are the trainable units). ``sampler`` is the port's own
    (``"host"`` or ``"device"``; the engine's streams are ``"device"``).
    On a mesh ``agg`` gives the reduce's tiers and ``mesh`` its shape."""
    comp = flcfg.compression
    mesh = flcfg.mesh
    agg_meta = None
    if mesh is not None:
        d = client_mesh_size(mesh)
        gs = flcfg.agg_group_size if (
            flcfg.agg_group_size and flcfg.agg_group_size < d) else d
        agg_meta = {"group_size": int(gs), "num_groups": int(d // gs),
                    "tiers": 1 if gs == d else 2}
    return {"run_id": run_id, "driver": driver, "algo": flcfg.algo,
            "agg": agg_meta, "shard_samples": bool(flcfg.shard_samples),
            "partition": partition_info,
            "mode": flcfg.mode, "sampler": sampler, "seed": seed,
            "start_round": start_round, "rounds": rounds,
            "num_clients": flcfg.num_clients,
            "clients_per_round": flcfg.clients_per_round,
            "top_n": flcfg.top_n,
            "quantize_bits": flcfg.quantize_bits,
            "compression": (None if comp is None else
                            {"bits": comp.bits,
                             "error_feedback": comp.error_feedback,
                             "fused": comp.fused}),
            "mesh": (dict(mesh.shape) if mesh is not None else None),
            "units": list(umap.names),
            "unit_bytes": [float(b) for b in umap.unit_bytes]}


def _telemetry(flcfg: FLConfig, verbose: bool, device, **meta):
    """The driver's ``(sink, profile window, ledger or None, sample
    system?)`` from ``flcfg.telemetry``; ``meta`` goes to
    :func:`_run_meta` for the ledger's run header. On a mesh only rank 0
    writes the ledger, prints and profiles (every rank holds the same
    model, losses and comm)."""
    tele = flcfg.telemetry
    sample_sys = tele is not None and tele.sample_system
    if flcfg.mesh is not None and flcfg.mesh.rank != 0:
        tele, verbose = None, False
    sink = ProgressSink.for_run(tele, verbose)
    win = prof_mod.ProfileWindow.from_config(tele, device)
    ledger = None
    if tele is not None and tele.wants_ledger:
        ledger = RoundLedger(tele.ledger_path, meta=_run_meta(
            flcfg, run_id=tele.run_id, **meta))
    return sink, win, ledger, sample_sys


def _device_shards(fldata, device, flcfg: FLConfig) -> ClientShards:
    """The dataset on the run's device; on a mesh placed for this rank
    (:meth:`ClientShards.place`, with ``flcfg.shard_samples``)."""
    shards = (fldata if isinstance(fldata, ClientShards)
              else ClientShards.from_federated(fldata))
    if flcfg.mesh is not None:
        return shards.place(flcfg.mesh, shard_samples=flcfg.shard_samples)
    return shards.to(device)


def run_training(params: Pytree, loss_fn, fldata, flcfg: FLConfig,
                 rounds: int,
                 eval_fn: Optional[Callable[[Pytree], float]] = None,
                 eval_every: int = 10, seed: int = 0,
                 verbose: bool = False,
                 sampler: str = "host",
                 start_round: int = 0,
                 server_state: Optional[dict] = None,
                 device="cuda", *, draws=None
                 ) -> tuple[Pytree, TrainLog]:
    """Full FL training loop (paper Algorithm 1 ServerExecute), host-driven.

    One Python iteration and one host pull (the loss) a round, on
    ``device`` (the card unless the caller asks for ``"cpu"``); ``params``
    are moved there. ``sampler`` picks the streams:

    - ``"host"`` (default): numpy client sampling and batch gathering from
      ``fldata`` (a :class:`~repro_torch.data.FederatedData`), the
      reference's ``sampler="host"`` stream; the random policies draw from
      the keyed algorithm stream of ``(seed, t)``;
    - ``"device"``: the engine's keyed streams (clients, sample indices,
      algorithm uniforms) and its device gather from
      :class:`~repro_torch.data.ClientShards` (``fldata`` may be either),
      so one seed gives :func:`run_training_scan`'s trajectory bit for bit.

    ``draws`` (keyword-only) replaces the keyed streams: a callable ``t ->``
    round draws with ``clients``, ``indices`` and ``uniform`` (see
    :class:`~repro_torch.federated.sampling.KeyedDraws`); with the host
    sampler only its ``uniform`` is used. The reference's
    ``sampler="jax"`` (JAX's threefry streams) is not reproduced.

    Strategy state is declared once and threaded through the rounds;
    client-entry rows are gathered before a round and scattered back
    after, and the final state lands in ``log.final_state``. To resume,
    pass ``start_round=<rounds done>`` and ``server_state=<saved state>``:
    with the keyed streams the continuation is bit-identical to the
    uninterrupted run (the host sampler's sequential numpy stream is not
    resumable).

    With ``flcfg.partition`` only the trainable leaves are trained,
    scored, uploaded and carried in the strategy state; ``eval_fn`` sees
    and the driver returns the full model, whose frozen leaves are the
    given tensors (on ``device``), untouched.

    With ``flcfg.mesh`` every rank of the mesh calls this with the same
    arguments and runs on the mesh's device (of ``device``'s type): both
    samplers draw the whole cohort on every rank and each rank gathers its
    K/C rows; ``flcfg.shard_samples`` needs ``sampler="device"``. Every
    rank returns the same model and log. On a 2-D mesh the params, the
    frozen base and the EF store are held as the rank's shards between
    rounds; ``eval_fn`` sees and the driver returns the whole model
    (gathered over the rank's row), ``log.final_state`` is the rank's
    shards, and ``server_state`` may be whole or such shards.
    """
    if sampler == "jax":
        raise NotImplementedError(
            "sampler='jax' is not ported (ROADMAP Queue 1, item 7): JAX's "
            "threefry streams are not reproduced in torch. Use the port's "
            "keyed streams (sampler='device') or the reference's numpy "
            "stream (sampler='host')")
    if sampler not in ("host", "device"):
        raise ValueError(f"sampler must be 'host' or 'device', got "
                         f"{sampler!r}")
    device = _device_of(device, flcfg)
    params, frozen, pinfo = _split(
        tree_map(lambda l: l.to(device), params), flcfg)
    umap = UnitMap.build(params)
    strategy = make_strategy(flcfg)
    params, frozen, state, layout = _place(strategy, params, frozen, flcfg,
                                           server_state, device)
    round_fn = build_round_fn(loss_fn, umap, flcfg, layout=layout)
    draws = draws if draws is not None else KeyedDraws(seed)
    n_, k_, b_ = (flcfg.num_clients, flcfg.clients_per_round,
                  flcfg.batch_per_client)
    rows = _rank_rows(flcfg)
    if sampler == "device":
        shards = _device_shards(fldata, device, flcfg)
        host_sizes = shards.part_sizes.cpu()
        all_sizes = shards.data_sizes()
    elif flcfg.shard_samples:
        raise ValueError(
            "FLConfig.shard_samples needs sampler='device' (the host sampler "
            "never builds device-resident ClientShards)")
    else:
        rng = np.random.default_rng(seed)
        host_all_sizes = fldata.data_sizes()
    log = TrainLog()
    sink, win, ledger, sample_sys = _telemetry(
        flcfg, verbose, device, driver="host", umap=umap, seed=seed,
        sampler=sampler, start_round=start_round, rounds=rounds,
        partition_info=pinfo)
    last = start_round + rounds - 1
    whole = None
    try:
        for t in range(start_round, start_round + rounds):
            whole = None
            win.round_begin(t)
            wall0 = time.perf_counter() if sample_sys else None
            rd = draws(t)
            if sampler == "device":
                clients = rd.clients(n_, k_,
                                     shards.num_groups).to(torch.int64)
                _check_rank_clients(flcfg, clients, rows)
                j = rd.indices(host_sizes[clients], b_)
                idx = host_to_device(clients, device)
                batch = shards.gather(idx[rows],
                                      host_to_device(j[rows], device))
                sizes = all_sizes[idx[rows]]
            else:
                clients = sample_clients(rng, n_, k_)
                batch = fldata.round_batch(clients, b_, rng)
                batch = {name: torch.from_numpy(v[rows]).to(device)
                         for name, v in batch.items()}
                sizes = torch.from_numpy(
                    host_all_sizes[clients][rows]).to(device)
                idx = torch.from_numpy(clients).to(device)
            params, state, metrics = _step(round_fn, params, state, batch,
                                           sizes, idx, rd, device, frozen,
                                           rows)
            log.meter.update(metrics["comm"])
            log.rounds.append(t)
            loss_t = float(metrics["loss"])     # device sync
            log.losses.append(loss_t)
            log.uplink_mb.append(log.meter.uplink_bytes / 1e6)
            if ledger is not None:
                # the float() pull above synced the round, so wall_s is
                # the round's time, not its enqueue
                wall_s = (time.perf_counter() - wall0
                          if wall0 is not None else None)
                mem = (prof_mod.device_memory_peak(device) if sample_sys
                       else None)
                out = _pull(_round_outputs(metrics, flcfg.telemetry))[0]
                ledger.round(t, loss_t, out["comm"], log.meter.uplink_bytes,
                             taps=out.get("taps"),
                             selection=out.get("selection"),
                             wall_s=wall_s, mem_peak_bytes=mem)
            if eval_fn is not None and (t % eval_every == 0 or t == last):
                whole = _whole(params, frozen, flcfg, layout)
                err = float(eval_fn(whole))
                log.test_errors.append((t, err, log.meter.uplink_bytes))
                if ledger is not None:
                    ledger.eval(t, err, log.meter.uplink_bytes)
                sink.round(t, loss_t, test_error=err,
                           uplink_bytes=log.meter.uplink_bytes)
            elif sink.enabled and t % 10 == 0:
                sink.round(t, loss_t)
            win.round_end(t)
    finally:
        win.close()
        if ledger is not None:
            ledger.close()
    log.final_state = state
    if whole is None:
        whole = _whole(params, frozen, flcfg, layout)
    return whole, log


# ======================================================================
# Device-resident multi-round engine
# ======================================================================
def _eval_cuts(rounds: int, eval_every: int, do_eval: bool) -> list[int]:
    """Block boundaries: cut after round t iff the host driver would eval
    there (t % eval_every == 0 or t == rounds-1); one block when not
    evaluating."""
    if not do_eval:
        return [rounds]
    return sorted({t + 1 for t in range(rounds)
                   if t % eval_every == 0 or t == rounds - 1})


def _round_outputs(metrics: dict, tele: TelemetryConfig) -> dict:
    """What the ledger records of a round's metrics: ``comm``, and the
    ``taps`` and ``selection`` when ``tele`` asks for them."""
    out = {"comm": metrics["comm"]}
    if tele.taps:
        out["taps"] = metrics["taps"]
    if tele.full_selection:
        out["selection"] = metrics["selection"]
    return out


def _pull(tree: dict) -> tuple[dict, int]:
    """A nested dict of device tensors on the host, in one copy a dtype:
    the leaves of each dtype are flattened into one buffer, copied once
    (the one sync) and split back into their shapes. Returns the host
    tree and the number of copies."""
    items: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, v in node.items():
                walk(v, path + (key,))
        else:
            items.setdefault(node.dtype, []).append((path, node))

    walk(tree, ())
    out: dict = {}
    for group in items.values():
        buf = torch.cat([t.reshape(-1) for _, t in group]).cpu()
        for (path, t), piece in zip(group, buf.split(
                [t.numel() for _, t in group])):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = piece.view(t.shape)
    return out, len(items)


def _build_block_fn(loss_fn, umap: UnitMap, flcfg: FLConfig,
                    layout: Optional[ModelLayout] = None):
    """Multi-round block: ``run_block(carry, shards, all_sizes, host_sizes,
    draws, t0, num) -> (carry, per_round)`` advances the carry (params,
    strategy state, comm accumulator) by ``num`` rounds from the absolute
    round ``t0``, issuing device work only: the block's participants and
    sample indices are drawn on the host (``host_sizes`` is the CPU copy of
    ``shards.part_sizes``) and copied to the device once, through pinned
    memory; nothing in the loop synchronises. ``per_round`` holds the
    (num,) device tensors ``loss`` and ``uplink_bytes`` (cumulative, f32,
    as the reference's scan carry); a stateless strategy carries ``None``.
    With ``flcfg.telemetry`` it also holds each round's ``comm`` (a dict of
    (num,) tensors) and, as the config asks, ``taps`` (a dict of (num,
    ...) tensors) and ``selection`` (num, K, U), stacked on the device at
    the block's end; the carry does not grow. ``frozen`` is the frozen base
    of a partitioned run (see :func:`build_round_vmap`). On a 2-D mesh the
    carry's params and state and ``frozen`` are the rank's shards of
    ``layout``.
    """
    round_fn = build_round_fn(loss_fn, umap, flcfg, layout=layout)
    tele = flcfg.telemetry
    n_, k_, b_ = (flcfg.num_clients, flcfg.clients_per_round,
                  flcfg.batch_per_client)
    rows = _rank_rows(flcfg)

    def run_block(carry, shards: ClientShards, all_sizes: torch.Tensor,
                  host_sizes: torch.Tensor, draws, t0: int, num: int,
                  frozen: Optional[Pytree] = None):
        params, state, acc = carry
        device = all_sizes.device
        with span("engine.draws"):
            rds = [draws(t) for t in range(t0, t0 + num)]
            clients = torch.stack([rd.clients(n_, k_, shards.num_groups)
                                   .to(torch.int64) for rd in rds])  # (num, K)
            _check_rank_clients(flcfg, clients, rows)
            # every rank draws all K clients' indices (one stream) and
            # copies its own rows' (num, K/D, B)
            j = torch.stack([rd.indices(host_sizes[c], b_).to(torch.int64)
                             for rd, c in zip(rds, clients)])[:, rows]
            # one copy of the whole block's draws
            drawn = host_to_device(torch.cat([clients.reshape(-1),
                                              j.reshape(-1)]), device)
            clients_d = drawn[:clients.numel()].view(clients.shape)
            j_d = drawn[clients.numel():].view(j.shape)
        losses = torch.empty(num, dtype=torch.float32, device=device)
        uplink = torch.empty(num, dtype=torch.float32, device=device)
        outs = []
        for i, rd in enumerate(rds):
            with span("engine.round"):
                idx = clients_d[i]
                params, state, metrics = _step(
                    round_fn, params, state,
                    shards.gather(idx[rows], j_d[i]), all_sizes[idx[rows]],
                    idx, rd, device, frozen, rows)
                acc = comm_mod.comm_acc_update(acc, metrics["comm"])
                losses[i] = metrics["loss"]
                uplink[i] = acc["uplink_bytes"]
                if tele is not None:
                    outs.append(_round_outputs(metrics, tele))
        per_round = {"loss": losses, "uplink_bytes": uplink}
        if outs:
            per_round.update(tree_map(lambda *ls: torch.stack(ls), *outs))
        return (params, state, acc), per_round

    return run_block


def run_training_scan(params: Pytree, loss_fn, fldata, flcfg: FLConfig,
                      rounds: int,
                      eval_fn: Optional[Callable[[Pytree], float]] = None,
                      eval_every: int = 10, seed: int = 0,
                      verbose: bool = False,
                      start_round: int = 0,
                      server_state: Optional[dict] = None,
                      device="cuda", *, draws=None
                      ) -> tuple[Pytree, TrainLog]:
    """Device-resident FL training, one block of rounds between two
    evaluations at a time.

    Client sampling, round-batch gathering from device-resident
    :class:`~repro_torch.data.ClientShards`, local training, selection,
    aggregation, communication accounting and strategy state updates (EF
    residuals, FedLAMA intervals, …) are enqueued on ``device`` (the card
    unless the caller asks for ``"cpu"``) without a host sync; the
    per-round losses and cumulative uplink come back in one host pull a
    block, and ``log.meter`` from the device accumulator at the end.

    ``fldata`` may be a :class:`~repro_torch.data.FederatedData` (copied to
    the device once) or prebuilt ``ClientShards``. Same seed ⇒ the same
    trajectory as ``run_training(sampler="device")``, bit for bit.
    ``draws`` (keyword-only) replaces the keyed streams, as there.

    Resume: round ``t``'s draws are a pure function of ``(seed, t)`` with
    ``t`` the absolute round index, so ``start_round=<rounds done>,
    server_state=<log.final_state or a loaded checkpoint>`` continues a run
    bit-identically to one that never stopped. ``server_state`` is copied
    once at entry; the caller's tensors are not written.

    ``flcfg.partition`` and ``flcfg.mesh`` are handled as in
    :func:`run_training`.
    """
    device = _device_of(device, flcfg)
    with span("engine.enter"):
        params, frozen, pinfo = _split(
            tree_map(lambda l: l.to(device), params), flcfg)
        umap = UnitMap.build(params)
        shards = _device_shards(fldata, device, flcfg)
        strategy = make_strategy(flcfg)
        params, frozen, state0, layout = _place(strategy, params, frozen,
                                                flcfg, server_state, device)
        run_block = _build_block_fn(loss_fn, umap, flcfg, layout)
        carry = (params, state0, comm_mod.comm_acc_init(device))
        all_sizes = shards.data_sizes()
        host_sizes = shards.part_sizes.cpu()
    draws = draws if draws is not None else KeyedDraws(seed)
    log = TrainLog()
    sink, win, ledger, sample_sys = _telemetry(
        flcfg, verbose, device, driver="scan", umap=umap, seed=seed,
        sampler="device", start_round=start_round, rounds=rounds,
        partition_info=pinfo)
    t0 = 0
    whole = None
    try:
        for cut in _eval_cuts(rounds, eval_every, eval_fn is not None):
            whole = None
            num = cut - t0
            win.block_begin(start_round + t0, start_round + cut)
            wall0 = time.perf_counter() if sample_sys else None
            carry, per_round = run_block(carry, shards, all_sizes,
                                         host_sizes, draws, start_round + t0,
                                         num, frozen)
            # the block's one host pull (one copy a dtype: a single f32
            # copy of losses, uplink, comm, taps and selection)
            with span("engine.pull"):
                host = _pull(per_round)[0]
            losses, uplink = host["loss"], host["uplink_bytes"]
            # the pull synced the block, so its wall time is the block's
            # time; a round's is the block's over num
            block_wall = (time.perf_counter() - wall0
                          if wall0 is not None else None)
            log.rounds.extend(range(start_round + t0, start_round + cut))
            log.losses.extend(float(x) for x in losses)
            log.uplink_mb.extend(float(u) / 1e6 for u in uplink)
            if ledger is not None:
                wall_each = (block_wall / num
                             if block_wall is not None else None)
                mem = (prof_mod.device_memory_peak(device) if sample_sys
                       else None)
                for i in range(num):
                    ledger.round(
                        start_round + t0 + i, losses[i],
                        tree_map(lambda a, i=i: a[i], host["comm"]),
                        uplink[i],
                        taps=(tree_map(lambda a, i=i: a[i], host["taps"])
                              if "taps" in host else None),
                        selection=(host["selection"][i]
                                   if "selection" in host else None),
                        wall_s=wall_each, mem_peak_bytes=mem)
            t_last = start_round + cut - 1
            if eval_fn is not None:
                whole = _whole(carry[0], frozen, flcfg, layout)
                err = float(eval_fn(whole))
                log.test_errors.append((t_last, err, float(uplink[-1])))
                if ledger is not None:
                    ledger.eval(t_last, err, float(uplink[-1]))
                sink.round(t_last, float(losses[-1]), test_error=err,
                           uplink_bytes=float(uplink[-1]))
            elif sink.enabled:
                sink.round(t_last, float(losses[-1]))
            win.block_end(start_round + cut)
            t0 = cut
    finally:
        win.close()
        if ledger is not None:
            ledger.close()
    with span("engine.exit"):
        params, final_state, acc = carry
        log.meter = comm_mod.CommMeter.from_accumulator(acc)
        log.final_state = final_state
        if whole is None:
            whole = _whole(params, frozen, flcfg, layout)
    return whole, log
