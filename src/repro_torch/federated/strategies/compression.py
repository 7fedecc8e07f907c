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
  (:mod:`repro_torch.kernels.uplink`: one launch a round over every leaf
  without error feedback, one a leaf with it), which never build
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
from repro_torch.core.units import tree_map
from repro_torch.core.wire import CompressionConfig
from repro_torch.federated.strategies.base import FLStrategy
from repro_torch.kernels import ops as kops
from repro_torch.launch.sharding import init_residual_store


def _split(out, i: int):
    """Element ``i`` of every tuple leaf of a tree of tuples."""
    if isinstance(out, dict):
        return {key: _split(v, i) for key, v in out.items()}
    return out[i]


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
                       fused_uplink_ef: Optional[Callable] = None):
        """Stacked locals → packed payload → fused kernel reduction.

        Returns ``(num_parts, denom, new_res_rows, wire)``: ``num_parts``
        is the param-structured additive Eq. 5 numerator ``Σ_k w[k,u]·Θ̂_k
        = denom_u·Ĝ + Σ_k w·scale·levels`` (the second term through the
        fused uplink kernels: without error feedback one
        ``fused_uplink_leaves`` call over every leaf, one launch a round;
        with it one ``fused_uplink_ef`` launch a leaf), ``denom`` the
        ``(U,)`` weight sums, and ``wire`` the payload's accounting plus the
        payload itself (``"payload"``). ``fused_uplink_leaves`` and
        ``fused_uplink_ef`` default to :mod:`repro_torch.kernels.ops`'s
        (the CUDA kernels for CUDA tensors); passing the plain versions
        runs the same round without the kernels.
        """
        uplink_leaves = fused_uplink_leaves or kops.fused_uplink_leaves
        uplink_ef = fused_uplink_ef or kops.fused_uplink_ef
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

        num_parts, res_parts = {}, ({} if ef else None)
        if not ef:
            # every leaf of the round through one grouped call: (K, n, C)
            # levels, each unit one row, and the (K, n) scales and weights
            calls = []
            for key, (off, n) in umap.spans.items():
                s_seg = scales_k[:, off:off + n].contiguous()
                w_seg = w[:, off:off + n].contiguous()
                tree_map(lambda lv, n=n, s_seg=s_seg, w_seg=w_seg:
                         calls.append((lv.reshape(k, n, -1), s_seg, w_seg)),
                         levels_k[key])
            nums = iter(uplink_leaves(*(list(c) for c in zip(*calls))))
            for key, (off, n) in umap.spans.items():
                d_seg = denom[off:off + n]
                num_parts[key] = tree_map(
                    lambda lv, g_leaf, d_seg=d_seg, n=n:
                    finish(next(nums), g_leaf, d_seg, n),
                    levels_k[key], global_params[key])
        else:
            for key, (off, n) in umap.spans.items():
                w_seg = w[:, off:off + n].contiguous()
                s_seg = scales_k[:, off:off + n].contiguous()
                g_seg = sel_rows[:, off:off + n].contiguous()
                d_seg = denom[off:off + n]

                def reduce_leaf(lv, vv, g_leaf, ee):
                    # (K, n, ...) stacked or (K, ...): each unit is one row
                    num2, res2 = uplink_ef(lv.reshape(k, n, -1), s_seg, w_seg,
                                           g_seg, vv.reshape(k, n, -1),
                                           ee.reshape(k, n, -1))
                    return (finish(num2, g_leaf, d_seg, n),
                            res2.reshape((k,) + g_leaf.shape))

                out = tree_map(reduce_leaf, levels_k[key], v_k[key],
                               global_params[key], res_rows[key])
                num_parts[key] = _split(out, 0)
                res_parts[key] = _split(out, 1)

        wire = {"unit_bytes": payload.unit_wire_bytes(umap), "bits": bits,
                "nbytes": payload.nbytes, "payload": payload}
        return num_parts, denom, res_parts, wire

    def uplink_round(self, locals_, global_params, umap, selection, divs,
                     data_sizes, res_rows, *,
                     fused_uplink_leaves: Optional[Callable] = None,
                     fused_uplink_ef: Optional[Callable] = None):
        parts, denom, new_rows, wire = self._packed_reduce(
            locals_, global_params, umap, selection, divs, data_sizes,
            res_rows, fused_uplink_leaves=fused_uplink_leaves,
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
