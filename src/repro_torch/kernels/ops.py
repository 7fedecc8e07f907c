"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written CUDA kernel, which launches or
raises; a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. The tensor's device is the only thing that
decides: there is no switch and no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import aggregate as _aggregate
from repro_torch.kernels import divergence as _divergence
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import uplink as _uplink

# Every kernel the port launches, as its launch counter names it;
# ``flash_attention`` counts all three of its routes' launches.
KERNELS = ("sqdiff_rowsum", "masked_accumulate", "fused_uplink",
           "fused_uplink_ef", "flash_attention", "flash_attention_tc",
           "flash_attention_decode", "flash_attention_cuda_core")


def sqdiff_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, C), (R_b, C) -> (R,) float32 per-row Σ(a − b[r % R_b])²."""
    if a.device.type == "cuda":
        return _divergence.sqdiff_rowsum(a, b)
    return _ref.sqdiff_rowsum(a, b)


def sqdiff_rowsum_leaves(a: list[torch.Tensor], b: list[torch.Tensor],
                         units: list[tuple[int, int]]) -> torch.Tensor:
    """(K·n_i, C_i), (n_i, C_i) leaf pairs at units ``(off_i, n_i)`` ->
    (K, U) float32 per-unit sums of :func:`sqdiff_rowsum`, each unit's
    leaves added in list order from 0: one kernel call for them all on
    CUDA."""
    if a and a[0].device.type == "cuda":
        return _divergence.sqdiff_rowsum_leaves(a, b, units)
    return _ref.sqdiff_rowsum_leaves(a, b, units)


def masked_accumulate(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(R, C), (R, C), (R,) -> (R, C) float32 ``acc + w[:, None] * x``,
    into ``out`` when given (``out=acc``: in place)."""
    if acc.device.type == "cuda":
        return _aggregate.masked_accumulate(acc, x, w, out)
    return _ref.masked_accumulate(acc, x, w, out)


def masked_accumulate_leaves(accs: list[torch.Tensor],
                             xs: list[torch.Tensor],
                             ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """:func:`masked_accumulate` in place over every (acc, x, w) leaf: one
    kernel launch for them all on CUDA. Returns ``accs``."""
    if accs and accs[0].device.type == "cuda":
        return _aggregate.masked_accumulate_leaves(accs, xs, ws)
    return _ref.masked_accumulate_leaves(accs, xs, ws)


def fused_uplink(levels: torch.Tensor, scales: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """(K, R, C) int8, (K, R), (K, R) -> (R, C) float32
    ``Σ_k w[k,r]·scales[k,r]·levels[k,r,:]``."""
    if levels.device.type == "cuda":
        return _uplink.fused_uplink(levels, scales, w)
    return _ref.fused_uplink(levels, scales, w)


def fused_uplink_leaves(levels: list[torch.Tensor],
                        scales: list[torch.Tensor],
                        ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """:func:`fused_uplink` of every (levels, scales, w) leaf: one kernel
    launch for them all on CUDA."""
    if levels and levels[0].device.type == "cuda":
        return _uplink.fused_uplink_leaves(levels, scales, ws)
    return _ref.fused_uplink_leaves(levels, scales, ws)


def fused_uplink_ef(levels: torch.Tensor, scales: torch.Tensor,
                    w: torch.Tensor, gate: torch.Tensor, v: torch.Tensor,
                    e_old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_uplink` plus the gated error-feedback residual
    ``gate·(v − recon) + (1 − gate)·e_old`` (K, R, C) float32."""
    if levels.device.type == "cuda":
        return _uplink.fused_uplink_ef(levels, scales, w, gate, v, e_old)
    return _ref.fused_uplink_ef(levels, scales, w, gate, v, e_old)


def fused_uplink_ef_leaves(levels: list[torch.Tensor],
                           v: list[torch.Tensor], e_old: list[torch.Tensor],
                           units: list[tuple[int, int]],
                           scales: torch.Tensor, w: torch.Tensor,
                           gate: torch.Tensor
                           ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:func:`fused_uplink_ef` of every (levels, v, e_old) leaf at units
    ``(off_i, n_i)`` of the round's (K, U) scales, w and gate: one kernel
    launch for them all on CUDA."""
    if levels and levels[0].device.type == "cuda":
        return _uplink.fused_uplink_ef_leaves(levels, v, e_old, units,
                                              scales, w, gate)
    return _ref.fused_uplink_ef_leaves(levels, v, e_old, units, scales, w,
                                       gate)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """GQA softmax attention with causal, window and ``k_pos < kv_len``
    masks; q (BH, Sq, hd) with k, v (BKV, Skv, hd), or q (B, Sq, H, hd)
    with k, v (B, Skv, KV, hd). A row with no key gives 0."""
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
    return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                kv_len=kv_len)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: _build.LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.LAUNCHES.clear()
