"""Quantize(+error-feedback) upload wrapper, as a composable strategy, port
of ``repro.federated.strategies.compression``.

``FLConfig(compression=CompressionConfig(...))`` composes
:class:`QuantizedUpload` around the configured base strategy (see
:func:`repro_torch.federated.strategies.make_strategy`): selection and
aggregation delegate to the inner strategy unchanged, while the per-client
payload is re-expressed as ``Ĝ + dequant(Q_b(Δ + e))`` with optional
client-side error feedback whose residuals advance only where a layer
actually shipped.

Two execution paths, chosen by ``CompressionConfig.fused``:

- **packed** (default): the stacked client deltas are quantized into a
  :class:`repro_torch.core.wire.PackedPayload` — int8/int4 level buffers,
  per-unit scales and a per-unit bit-width vector (constant, or
  waterfilled from the round's Eq. 3 divergence stats when
  ``bits="auto"``) — and dequantization, the EF residual update and the
  Eq. 5 numerator run through the fused uplink kernels
  (:mod:`repro_torch.kernels.uplink`: one launch a round over every leaf,
  with or without error feedback), which never build
  per-client f32 reconstructions. Comm accounting prices the payload's
  wire bytes (``PackedPayload.unit_wire_bytes``) through
  ``unit_bytes_override``.
- **legacy** (``fused=False``): the unfused chain — ``transform_upload``
  rebuilds f32 ``Θ̂`` per client, ``update_residual`` gates the EF rows,
  the inner strategy aggregates — the A/B reference the packed path is
  held to.

The reference's mesh half (``uplink_psum_parts``, ``psum_parts``) and its
telemetry taps wait for their slices (ROADMAP Queue 1, items 8 and 11).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import wire as wire_mod
from repro_torch.core.compress import compress_upload
from repro_torch.core.units import tree_leaves, tree_map
from repro_torch.core.wire import CompressionConfig
from repro_torch.federated.strategies.base import FLStrategy
from repro_torch.kernels import ops as kops
from repro_torch.launch.sharding import init_residual_store


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves, in ``tree_leaves`` order
    (sorted keys), are taken from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    return next(leaves)


class QuantizedUpload(FLStrategy):
    """Wrap ``inner`` with int-b delta quantization (+ error feedback)."""

    supports_scan = False       # quantized uploads need stacked clients
    supports_quantize = False   # no double-wrapping

    def __init__(self, inner: FLStrategy, cfg,
                 comp: CompressionConfig | None = None):
        super().__init__(cfg)
        comp = comp if comp is not None else getattr(cfg, "compression",
                                                      None)
        if not isinstance(comp, CompressionConfig):
            raise TypeError("QuantizedUpload needs a CompressionConfig, "
                            f"got {type(comp).__name__}")
        if not type(inner).supports_quantize:
            raise ValueError(f"strategy {inner.name!r} declares "
                             "supports_quantize=False")
        self.comp = comp
        self.inner = inner
        self.name = f"{inner.name}+q{comp.bits}"
        # mirror the inner strategy's declared behaviour (instance attrs
        # shadow the class-level flags)
        self.needs_divergence = inner.needs_divergence or comp.is_auto
        self.eq5_weighted = inner.eq5_weighted
        self.tracks_residuals = comp.error_feedback
        self.packed_upload = comp.fused
        self.transforms_upload = not comp.fused

    # ---- cross-round state: inner state + the EF residual store ----
    def init_state(self, params, num_clients):
        state = self.inner.init_state(params, num_clients)
        if self.tracks_residuals:
            state = dict(state or {})
            client = dict(state.get("client") or {})
            client["residual"] = init_residual_store(params, num_clients)
            state["client"] = client
        return state

    def select_with_state(self, state, divs, generator, k, u, n, device):
        return self.inner.select_with_state(state, divs, generator, k, u, n,
                                            device)

    def update_state(self, state, selection, divs, umap):
        # the engine already advanced the "residual" rows (through the
        # packed uplink or update_residual); the inner strategy's
        # transition must keep entries it does not own (the default
        # identity does)
        return self.inner.update_state(state, selection, divs, umap)

    # ---- delegated hooks ----
    def select(self, divs, generator, k, u, n, device):
        return self.inner.select(divs, generator, k, u, n, device)

    def aggregate(self, uploads, umap, selection, data_sizes, global_params):
        return self.inner.aggregate(uploads, umap, selection, data_sizes,
                                    global_params)

    def psum_finalize(self, parts, denom, umap, params, fallback):
        return self.inner.psum_finalize(parts, denom, umap, params, fallback)

    # ==================================================================
    # Packed wire-format path (CompressionConfig.fused)
    # ==================================================================
    def _packed_reduce(self, locals_, global_params, umap, sel_rows, divs,
                       data_sizes, res_rows, *,
                       fused_uplink_leaves: Optional[Callable] = None,
                       fused_uplink_ef_leaves: Optional[Callable] = None,
                       fused_uplink_ef: Optional[Callable] = None):
        """Stacked locals → packed payload → fused kernel reduction.

        Returns ``(num_parts, denom, new_res_rows, wire)``: ``num_parts``
        is the param-structured additive Eq. 5 numerator ``Σ_k w[k,u]·Θ̂_k
        = denom_u·Ĝ + Σ_k w·scale·levels`` (the second term through one
        grouped fused uplink call over every leaf, one kernel launch a
        round: ``fused_uplink_leaves`` without error feedback,
        ``fused_uplink_ef_leaves`` with it), ``denom`` the ``(U,)`` weight
        sums, and ``wire`` the payload's accounting plus the payload itself
        (``"payload"``). Both grouped entries default to
        :mod:`repro_torch.kernels.ops`'s (the CUDA kernels for CUDA
        tensors); passing the plain versions runs the same round without
        the kernels. ``fused_uplink_ef(levels, scales, w, gate, v, e_old)``
        is instead called once a leaf, as in the reference.
        """
        uplink_leaves = fused_uplink_leaves or kops.fused_uplink_leaves
        uplink_ef_leaves = (fused_uplink_ef_leaves
                            or kops.fused_uplink_ef_leaves)
        comp = self.comp
        k = sel_rows.shape[0]
        bits = comp.bits_vector(umap, divs, device=sel_rows.device)  # (U,)
        w, denom = agg.unit_weights(sel_rows, data_sizes)    # (K,U), (U,)
        ef = res_rows is not None

        # Δ+e in the leaf dtype first (bit-compatible with the legacy
        # chain's rounding), then f32 for the kernel
        if ef:
            v_k = tree_map(lambda loc, g, e: (loc - g + e.to(loc.dtype))
                           .float(), locals_, global_params, res_rows)
        else:
            v_k = tree_map(lambda loc, g: (loc - g).float(), locals_,
                           global_params)
        levels_k, scales_k = wire_mod.quantize_units(v_k, umap, bits,
                                                     stacked=True)
        # materialise the wire format (nibble-packs when every width ≤ 4);
        # nbytes/unit_wire_bytes below are computed from THIS payload
        payload = wire_mod.PackedPayload(
            wire_mod.pack_levels(levels_k, comp.storage_bits), scales_k,
            bits, storage_bits=comp.storage_bits)
        levels_k = wire_mod.unpack_levels(payload, v_k)

        def finish(num2, g_leaf, d_seg, n):
            # Σ_k w·Θ̂ = denom·Ĝ + Σ_k w·recon (the kernel term)
            num2 = num2 + d_seg[:, None] * g_leaf.float().reshape(n, -1)
            return num2.reshape(g_leaf.shape)

        # every leaf of the round as (K, n, C): each unit one row
        lv3, units = [], []
        for key, (off, n) in umap.spans.items():
            for lv in tree_leaves(levels_k[key]):
                lv3.append(lv.reshape(k, n, -1))
                units.append((off, n))
        if not ef:
            # the (K, n) scales and weights of each leaf's units, a copy a
            # unit
            segs = {off: (scales_k[:, off:off + n].contiguous(),
                          w[:, off:off + n].contiguous())
                    for off, n in umap.spans.values()}
            outs = uplink_leaves(lv3, [segs[off][0] for off, _ in units],
                                 [segs[off][1] for off, _ in units])
        else:
            v3 = [vv.reshape(k, n, -1) for key, (off, n) in umap.spans.items()
                  for vv in tree_leaves(v_k[key])]
            e3 = [ee.reshape(k, n, -1) for key, (off, n) in umap.spans.items()
                  for ee in tree_leaves(res_rows[key])]
            gate = sel_rows.float().contiguous()
            if fused_uplink_ef is None:
                # the round's shared (K, U) scales, weights and gates
                outs = uplink_ef_leaves(lv3, v3, e3, units,
                                        scales_k.contiguous(),
                                        w.contiguous(), gate)
            else:
                outs = [fused_uplink_ef(lv, scales_k[:, off:off + n]
                                        .contiguous(),
                                        w[:, off:off + n].contiguous(),
                                        gate[:, off:off + n].contiguous(),
                                        vv, ee)
                        for lv, vv, ee, (off, n) in zip(lv3, v3, e3, units)]
        outs = iter(outs)
        num_parts, res_parts = {}, ({} if ef else None)
        for key, (off, n) in umap.spans.items():
            d_seg = denom[off:off + n]
            nums, ress = [], []
            for g_leaf in tree_leaves(global_params[key]):
                out = next(outs)
                num2, res2 = out if ef else (out, None)
                nums.append(finish(num2, g_leaf, d_seg, n))
                if ef:
                    ress.append(res2.reshape((k,) + g_leaf.shape))
            num_parts[key] = _unflatten(global_params[key], iter(nums))
            if ef:
                res_parts[key] = _unflatten(global_params[key], iter(ress))

        wire = {"unit_bytes": payload.unit_wire_bytes(umap), "bits": bits,
                "nbytes": payload.nbytes, "payload": payload}
        return num_parts, denom, res_parts, wire

    def uplink_round(self, locals_, global_params, umap, selection, divs,
                     data_sizes, res_rows, *,
                     fused_uplink_leaves: Optional[Callable] = None,
                     fused_uplink_ef_leaves: Optional[Callable] = None,
                     fused_uplink_ef: Optional[Callable] = None):
        parts, denom, new_rows, wire = self._packed_reduce(
            locals_, global_params, umap, selection, divs, data_sizes,
            res_rows, fused_uplink_leaves=fused_uplink_leaves,
            fused_uplink_ef_leaves=fused_uplink_ef_leaves,
            fused_uplink_ef=fused_uplink_ef)
        new_params = self.psum_finalize(parts, denom, umap, global_params,
                                        global_params)
        return new_params, new_rows, wire

    # ==================================================================
    # Legacy unfused chain (CompressionConfig.fused=False)
    # ==================================================================
    def transform_upload(self, local, global_params, umap, residual):
        # Θ̂ = Ĝ + dequant(Q_b(Δ + e)); divergence feedback (Eq. 3) was
        # already computed on the TRUE local model by the engine, so only
        # the uploaded payload is affected.
        return compress_upload(local, global_params, umap,
                               int(self.comp.bits), residual)

    def update_residual(self, cand_res, old_res, sel_row, umap,
                        global_params):
        # residuals advance only where a layer was actually uploaded
        # (s[k,u] = 1); elsewhere the old residual is carried forward.
        gate = umap.expand_to_leaves(cand_res, sel_row)
        old = (old_res if old_res is not None
               else agg.streaming_init(global_params))
        return tree_map(lambda g_, n_, o_: g_ * n_ + (1 - g_) * o_,
                        gate, cand_res, old)

    # ==================================================================
    def comm_profile(self, selection, umap, param_bytes_override=None,
                     unit_bytes_override=None):
        if unit_bytes_override is None:
            if not self.comp.fused:
                # legacy pricing: uniform b/8 bytes per parameter
                return self.inner.comm_profile(
                    selection, umap,
                    param_bytes_override=int(self.comp.bits) / 8.0)
            # packed pricing at the configured widths; "auto" prices at
            # the avg_bits budget when no per-round vector is available
            # (the round passes its actual allocation through
            # unit_bytes_override)
            b = (float(self.comp.avg_bits) if self.comp.is_auto
                 else float(int(self.comp.bits)))
            p = torch.tensor(umap.unit_params, dtype=torch.float32,
                             device=selection.device)
            unit_bytes_override = (torch.ceil(p * b / 8.0)
                                   + wire_mod.UNIT_HEADER_BYTES)
        return self.inner.comm_profile(
            selection, umap, unit_bytes_override=unit_bytes_override)
