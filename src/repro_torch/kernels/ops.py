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
from repro_torch.kernels import ref as _ref


def sqdiff_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, C), (R_b, C) -> (R,) float32 per-row Σ(a − b[r % R_b])²."""
    if a.device.type == "cuda":
        return _divergence.sqdiff_rowsum(a, b)
    return _ref.sqdiff_rowsum(a, b)


def masked_accumulate(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(R, C), (R, C), (R,) -> (R, C) float32 ``acc + w[:, None] * x``,
    into ``out`` when given (``out=acc``: in place)."""
    if acc.device.type == "cuda":
        return _aggregate.masked_accumulate(acc, x, w, out)
    return _ref.masked_accumulate(acc, x, w, out)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: _build.LAUNCHES[name]
            for name in ("sqdiff_rowsum", "masked_accumulate")}


def reset_launch_counts() -> None:
    _build.LAUNCHES.clear()
