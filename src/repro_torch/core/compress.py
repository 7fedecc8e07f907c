"""Quantized delta upload with error feedback — the legacy unfused chain,
port of ``repro.core.compress``.

Each *selected* layer can be uploaded as a quantized **delta** against the
broadcast global model (the client already holds Ĝ^t):

    upload_k = Q_b(Θ_k − Ĝ + e_k),   e_k' = (Θ_k − Ĝ + e_k) − Q_b(...)

with symmetric per-layer-unit int-b quantization Q_b and client-side error
feedback e_k. The server reconstructs Θ̂_k = Ĝ + dequant and aggregates
with Eq. 5 unchanged. The divergence feedback (Eq. 3) is computed on the
*unquantized* local model, so the protocol is unchanged upstream.

This chain builds f32 reconstructions per client; the packed path
(:mod:`repro_torch.core.wire` + the fused uplink kernels) is the default,
and this one is its A/B reference (``CompressionConfig(fused=False)``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.units import UnitMap, tree_leaves, tree_map, tree_sub

Pytree = Any


def quantize_unit_symmetric(delta: Pytree, umap: UnitMap, bits: int
                            ) -> tuple[Pytree, torch.Tensor]:
    """Symmetric per-unit quantization of one model's delta. Returns (integer
    levels as a float tree, per-unit scales (U,)). Levels ∈ [−(2^{b−1}−1),
    2^{b−1}−1]."""
    qmax = float(2 ** (bits - 1) - 1)
    first = tree_leaves(delta)[0]
    maxabs = torch.zeros(umap.num_units, dtype=torch.float32,
                         device=first.device)
    for key, (off, n) in umap.spans.items():
        for leaf in tree_leaves(delta[key]):
            flat = leaf.float().abs().reshape(n, -1).amax(dim=1)
            maxabs[off:off + n] = torch.maximum(maxabs[off:off + n], flat)
    scales = torch.clamp(maxabs, min=1e-12) / qmax
    inv = 1.0 / scales

    def q_key(key):
        off, n = umap.spans[key]
        seg = inv[off:off + n]

        def q(leaf):
            s = seg.reshape((n,) + (1,) * (leaf.ndim - 1)) if n > 1 else seg[0]
            return torch.round(torch.clamp(leaf.float() * s, -qmax, qmax))

        return tree_map(q, delta[key])

    return {k: q_key(k) for k in delta}, scales


def dequantize_unit(levels: Pytree, umap: UnitMap,
                    scales: torch.Tensor) -> Pytree:
    def dq_key(key):
        off, n = umap.spans[key]
        seg = scales[off:off + n]

        def dq(leaf):
            s = seg.reshape((n,) + (1,) * (leaf.ndim - 1)) if n > 1 else seg[0]
            return leaf * s

        return tree_map(dq, levels[key])

    return {k: dq_key(k) for k in levels}


def compress_upload(local: Pytree, global_params: Pytree, umap: UnitMap,
                    bits: int, residual: Optional[Pytree] = None
                    ) -> tuple[Pytree, Pytree]:
    """Client-side: returns (Θ̂ as the server reconstructs it, new residual).

    Θ̂ = Ĝ + dequant(Q(Δ + e));  e' = (Δ + e) − dequant(Q(Δ + e)).
    """
    delta = tree_sub(local, global_params)
    if residual is not None:
        delta = tree_map(lambda d, e: d + e.to(d.dtype), delta, residual)
    levels, scales = quantize_unit_symmetric(delta, umap, bits)
    recon_delta = dequantize_unit(levels, umap, scales)
    new_residual = tree_map(lambda d, r: d.float() - r, delta, recon_delta)
    theta_hat = tree_map(lambda g, r: (g.float() + r).to(g.dtype),
                         global_params, recon_delta)
    return theta_hat, new_residual


def quantized_bytes_per_param(bits: int) -> float:
    """Payload bytes per parameter (levels only; scales are U floats,
    negligible) — feeds CommMeter's param_bytes_override."""
    return bits / 8.0
