"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held to on the card, and
the path :mod:`repro_torch.kernels.ops` takes for tensors on the CPU. They
mirror ``src/repro/kernels/ref.py`` (f32 accumulation, f32 result), with
the two extensions the kernels have: ``b`` may be broadcast over client
blocks, and the accumulate may write in place.
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
