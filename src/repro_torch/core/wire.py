"""Packed uplink wire format, port of ``repro.core.wire``: what a compressed
upload actually is.

:class:`PackedPayload` holds per-unit symmetric-quantized **levels** as int8
(or int4 nibble pairs when every bit-width fits in 4), per-unit f32
**scales**, and a per-unit **bit-width vector**. ``nbytes`` and
``unit_wire_bytes`` are the single source of truth for comm accounting
(:func:`repro_torch.core.comm.round_comm` takes them through
``unit_bytes_override``), and the unpacked int8 levels are what the fused
uplink kernels (:mod:`repro_torch.kernels.uplink`) read.

Bit-widths may be **adaptive**: ``CompressionConfig(bits="auto")`` turns on
rate-distortion waterfilling (:func:`allocate_bits`) over the per-layer
divergence statistics FedLDF already computes (Eq. 3).

Per-unit wire cost is ``ceil(params·bits/8)`` level bytes plus a
:data:`UNIT_HEADER_BYTES` header (one f32 scale + one bit-width byte).

Unlike the reference, whose quantizer runs under ``jax.vmap``,
:func:`quantize_units` takes client-stacked deltas directly
(``stacked=True``): one pass per leaf covers all K clients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from repro_torch.core.units import UnitMap, tree_leaves, tree_map

Pytree = Any

# per-unit wire header: one f32 scale + one bit-width byte
UNIT_HEADER_BYTES = 5
_EPS = 1e-20


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Uplink compression policy (``FLConfig.compression``).

    bits            int 2..8 for a fixed width, or ``"auto"`` for
                    divergence-driven per-layer allocation.
    error_feedback  carry client-side quantization residuals across rounds.
    allocation      bit-allocation policy when ``bits == "auto"``
                    (only ``"waterfill"`` today).
    avg_bits        mean-bits-per-param budget for ``"auto"``.
    min_bits/max_bits  clamp range for allocated widths.
    fused           route through the packed wire format and the fused
                    uplink kernels; ``False`` keeps the legacy unfused f32
                    chain (the A/B reference).
    """
    bits: Union[int, str] = 8
    error_feedback: bool = False
    allocation: str = "waterfill"
    avg_bits: float = 4.0
    min_bits: int = 2
    max_bits: int = 8
    fused: bool = True

    def __post_init__(self):
        if isinstance(self.bits, str):
            if self.bits != "auto":
                raise ValueError(
                    f"CompressionConfig.bits must be an int in [2, 8] or "
                    f"'auto', got {self.bits!r}")
        elif not 2 <= int(self.bits) <= 8:
            raise ValueError(
                f"CompressionConfig.bits must be in [2, 8], got {self.bits}")
        if self.allocation != "waterfill":
            raise ValueError(
                f"unknown bit-allocation policy {self.allocation!r} "
                "(supported: 'waterfill')")
        if not 1 <= self.min_bits <= self.max_bits <= 8:
            raise ValueError(
                f"need 1 <= min_bits <= max_bits <= 8, got "
                f"[{self.min_bits}, {self.max_bits}]")
        if self.is_auto and not self.min_bits <= self.avg_bits <= self.max_bits:
            raise ValueError(
                f"avg_bits={self.avg_bits} outside "
                f"[min_bits={self.min_bits}, max_bits={self.max_bits}]")
        if self.is_auto and not self.fused:
            raise ValueError(
                "bits='auto' needs the packed wire format (fused=True); "
                "the legacy unfused chain only supports a fixed width")

    @property
    def is_auto(self) -> bool:
        return self.bits == "auto"

    @property
    def storage_bits(self) -> int:
        """Physical level storage: int4 nibble pairs when every possible
        width fits in 4 bits, else int8."""
        if self.is_auto:
            return 4 if self.max_bits <= 4 else 8
        return 4 if int(self.bits) <= 4 else 8

    def bits_vector(self, umap: UnitMap, divs: torch.Tensor | None = None,
                    device=None) -> torch.Tensor:
        """(U,) f32 logical bit-widths on ``device`` (``divs``'s when it is
        given) — constant for fixed ``bits``, waterfilled from the (K, U)
        divergence stats for ``"auto"``."""
        if not self.is_auto:
            return torch.full((umap.num_units,), float(int(self.bits)),
                              dtype=torch.float32, device=device)
        if divs is None:
            raise ValueError("bits='auto' needs divergence stats")
        return allocate_bits(divs, umap, avg_bits=self.avg_bits,
                             min_bits=self.min_bits, max_bits=self.max_bits)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class PackedPayload:
    """One (or a client-stacked batch of) packed uplink payload(s).

    levels   nested dict matching the model structure; int8 leaves holding
             the quantized levels (two int4 nibbles per byte along the
             last axis when ``storage_bits == 4``).
    scales   (..., U) f32 per-unit dequantization scales.
    bits     (U,) f32 per-unit logical bit-widths.
    storage_bits  physical width of the level buffers (8 or 4).
    """
    levels: Pytree
    scales: torch.Tensor
    bits: torch.Tensor
    storage_bits: int = 8

    @property
    def nbytes(self) -> int:
        """Physical packed size in bytes: int8 level buffers count one byte
        per element (nibble packing already halved them), plus the f32
        scales and one byte per bit-width entry."""
        lv = sum(leaf.numel() for leaf in tree_leaves(self.levels))
        return lv + 4 * self.scales.numel() + self.bits.numel()

    def unit_wire_bytes(self, umap: UnitMap) -> torch.Tensor:
        """(U,) f32 logical wire bytes per unit under the *allocated* widths:
        ``ceil(params·bits/8) + UNIT_HEADER_BYTES``. This — not f32 unit
        sizes — is what :func:`~repro_torch.core.comm.round_comm` charges
        for a packed upload."""
        p = umap.unit_params_tensor(self.bits.device)
        return torch.ceil(p * self.bits / 8.0) + UNIT_HEADER_BYTES


# ----------------------------------------------------------------------
# quantization with per-unit bit widths (generalizes core/compress to a
# (U,) bits vector; identical math to quantize_unit_symmetric when the
# vector is constant)

def quantize_units(delta: Pytree, umap: UnitMap, bits: torch.Tensor,
                   stacked: bool = False) -> tuple[Pytree, torch.Tensor]:
    """Symmetric per-unit quantization under per-unit widths.

    Returns (integer levels as an f32 tree in [−qmax_u, qmax_u], scales).
    ``stacked=True`` means every leaf carries a leading client axis K; the
    scales are then (K, U), else (U,). Computes ``1/scale`` and multiplies
    by it, and rounds half to even, as the reference does, so the levels
    and scales are bit-identical to its on the same f32 input.
    """
    first = tree_leaves(delta)[0]
    lead = first.shape[0] if stacked else 1
    qmax = torch.exp2(bits.float() - 1.0) - 1.0
    maxabs = torch.zeros((lead, umap.num_units), dtype=torch.float32,
                         device=first.device)
    for key, (off, n) in umap.spans.items():
        for leaf in tree_leaves(delta[key]):
            # (lead clients, n units, rest): one max per client and unit
            flat = leaf.float().abs().reshape(lead, n, -1).amax(dim=2)
            maxabs[:, off:off + n] = torch.maximum(maxabs[:, off:off + n],
                                                   flat)
    scales = torch.clamp(maxabs, min=1e-12) / qmax
    inv = 1.0 / scales

    def q_key(key):
        off, n = umap.spans[key]
        s = inv[:, off:off + n, None]
        qm = qmax[off:off + n, None]

        def q(leaf):
            x = leaf.float().reshape(lead, n, -1) * s
            return torch.round(torch.minimum(torch.maximum(x, -qm),
                                             qm)).reshape(leaf.shape)

        return tree_map(q, delta[key])

    return {k: q_key(k) for k in delta}, (scales if stacked else scales[0])


# ----------------------------------------------------------------------
# int4 nibble packing (last axis; odd tails zero-padded)

def _pack4(levels_i8: torch.Tensor) -> torch.Tensor:
    if levels_i8.shape[-1] % 2:
        pad = torch.zeros(levels_i8.shape[:-1] + (1,), dtype=levels_i8.dtype,
                          device=levels_i8.device)
        levels_i8 = torch.cat([levels_i8, pad], dim=-1)
    u = (levels_i8.to(torch.int16) + 8).to(torch.uint8)  # [-7,7] -> 1..15
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (lo | (hi << 4)).view(torch.int8)


def _unpack4(packed_i8: torch.Tensor, c: int) -> torch.Tensor:
    b = packed_i8.view(torch.uint8)
    lo = (b & 0xF).to(torch.int16) - 8
    hi = (b >> 4).to(torch.int16) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(b.shape[:-1] + (-1,))
    return out[..., :c].to(torch.int8).contiguous()


def pack_levels(levels: Pytree, storage_bits: int = 8) -> Pytree:
    """Quantized levels tree → physical wire buffers: int8 verbatim, or
    int4 nibble pairs along the last axis when ``storage_bits == 4``."""
    if storage_bits == 4:
        return tree_map(lambda l: _pack4(l.to(torch.int8)), levels)
    return tree_map(lambda l: l.to(torch.int8), levels)


def pack(delta: Pytree, umap: UnitMap, bits: torch.Tensor,
         storage_bits: int = 8) -> PackedPayload:
    """Quantize ``delta`` under the per-unit ``bits`` vector and pack the
    levels into int8 (or int4 nibble-pair) buffers."""
    levels, scales = quantize_units(delta, umap, bits)
    return PackedPayload(pack_levels(levels, storage_bits), scales, bits,
                         storage_bits=storage_bits)


def unpack_levels(payload: PackedPayload, ref: Pytree) -> Pytree:
    """Unpacked int8 levels, shaped like ``ref`` (the tree the payload was
    packed from — needed to recover odd last-dim sizes)."""
    if payload.storage_bits != 4:
        return payload.levels
    return tree_map(lambda lv, r: _unpack4(lv, r.shape[-1]),
                    payload.levels, ref)


def dequantize(payload: PackedPayload, umap: UnitMap, ref: Pytree) -> Pytree:
    """f32 delta reconstruction ``levels · scales`` of one payload (scales
    (U,)) — the unfused reference; the fused kernels never build it."""
    levels = unpack_levels(payload, ref)

    def dq_key(key):
        off, n = umap.spans[key]
        seg = payload.scales[off:off + n]

        def dq(leaf):
            s = seg.reshape((n,) + (1,) * (leaf.ndim - 1)) if n > 1 else seg[0]
            return leaf.float() * s

        return tree_map(dq, levels[key])

    return {k: dq_key(k) for k in levels}


# ----------------------------------------------------------------------
def allocate_bits(divs: torch.Tensor, umap: UnitMap, *,
                  avg_bits: float = 4.0, min_bits: int = 2,
                  max_bits: int = 8, iters: int = 40) -> torch.Tensor:
    """Reverse-waterfilling bit allocation from divergence statistics.

    Per-unit distortion proxy: the clients' mean squared divergence per
    parameter (Eq. 3 stats normalized by unit size). The rate-distortion
    shape ``b_u = clip(λ + ½log₂ σ²_u, min, max)`` is monotone in the water
    level λ, so a fixed-count bisection in f32 finds the largest λ whose
    parameter-weighted mean stays within ``avg_bits``; widths are floored
    to integers, which can only land the budget lower.
    """
    p = umap.unit_params_tensor(divs.device)
    d = divs.float()
    d = torch.mean(d * d, dim=0) if d.ndim == 2 else d * d
    r = 0.5 * torch.log2(torch.clamp(d / torch.clamp(p, min=1.0), min=_EPS))
    lo = torch.full((), float(min_bits), device=divs.device) - torch.max(r)
    hi = torch.full((), float(max_bits), device=divs.device) - torch.min(r)
    psum = torch.sum(p)

    def mean_bits(lam):
        return torch.sum(p * torch.clamp(lam + r, min_bits, max_bits)) / psum

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        over = mean_bits(mid) > avg_bits
        lo, hi = torch.where(over, lo, mid), torch.where(over, mid, hi)
    b = torch.clamp(lo + r, min_bits, max_bits)
    return torch.floor(b + 1e-4)

