"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held to on the card, and
the path :mod:`repro_torch.kernels.ops` takes for tensors on the CPU. They
mirror ``src/repro/kernels/ref.py`` (f32 accumulation, f32 result), with
the two extensions the kernels have: ``b`` may be broadcast over client
blocks, and the accumulate may write in place. The uplink sums run over
the client axis in a fixed ascending order (the reference's einsum leaves
the order open), so the CUDA kernels can match them bit for bit.
"""
from __future__ import annotations

import torch


def sqdiff_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row sum of squared differences, the inner reduction of Eq. 3.

    a: (R, C); b: (R_b, C) with R a multiple of R_b, so row r of ``a`` is
    compared with row ``r % R_b`` of ``b`` (R_b = R is the plain case).
    Returns (R,) float32.
    """
    rows, cols = a.shape
    d = (a.float().reshape(rows // b.shape[0], b.shape[0], cols)
         - b.float())
    return (d * d).sum(dim=-1).reshape(rows)


def masked_accumulate(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``acc + w[:, None] * x``, the Eq. 5 per-layer weighted accumulation.

    acc: (R, C) float32; x: (R, C) any float dtype; w: (R,). Returns (R, C)
    float32, written into ``out`` when given (``out=acc`` accumulates in
    place, as the CUDA kernel does).
    """
    return torch.add(acc, w.float()[:, None] * x.float(), out=out)


def fused_uplink(levels: torch.Tensor, scales: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[k,r]·scales[k,r]·levels[k,r,:]``: dequantization and the
    Eq. 5 numerator of a packed uplink.

    levels: (K, R, C) integer levels; scales, w: (K, R). Returns (R, C)
    float32. The sum runs over k in ascending order, one rounded product
    and one rounded add at a time, as the CUDA kernel does, so the two
    agree bit for bit.
    """
    num = torch.zeros(levels.shape[1:], dtype=torch.float32,
                      device=levels.device)
    for k in range(levels.shape[0]):
        recon = levels[k].float() * scales[k].float()[:, None]
        num = num + w[k].float()[:, None] * recon
    return num


def fused_uplink_ef(levels: torch.Tensor, scales: torch.Tensor,
                    w: torch.Tensor, gate: torch.Tensor, v: torch.Tensor,
                    e_old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_uplink` plus the error-feedback residual update.

    levels: (K, R, C); scales, w, gate: (K, R); v (= Δ + e) and e_old:
    (K, R, C) in any float dtype. Returns ``(num (R, C), new_res (K, R,
    C))`` float32 with ``new_res = gate·(v − recon) + (1 − gate)·e_old``,
    so rows with ``gate == 0`` keep ``e_old`` exactly.
    """
    recon = levels.float() * scales.float()[..., None]
    num = torch.zeros(levels.shape[1:], dtype=torch.float32,
                      device=levels.device)
    for k in range(levels.shape[0]):
        num = num + w[k].float()[:, None] * recon[k]
    g = gate.float()[..., None]
    res = g * (v.float() - recon) + (1.0 - g) * e_old.float()
    return num, res
