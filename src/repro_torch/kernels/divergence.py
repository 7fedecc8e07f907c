"""CUDA kernel launcher: per-unit Σ(a−b)², the Eq. 3 inner reduction, over
a table of leaves.

Replaces the Pallas TPU kernel ``src/repro/kernels/divergence.py``
(``sqdiff_rowsum`` / ``_sqdiff_kernel``). The kernel is
``csrc/divergence.cu``; its header says what bounds it on the card (bytes,
and launches when a model's leaves are small) and what the one C call over
a table of leaves (``csrc/leaf_table.cuh``) does about that: pass 1 writes
a partial a block, pass 2 sums each unit's leaves in leaf order.
:func:`sqdiff_rowsum_leaves` covers every leaf of a model in one C call;
:func:`sqdiff_rowsum`, the TPU kernel's signature, is the same kernel over
a one-entry table. The plain PyTorch versions are in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _leaves

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("divergence",
                       repro_sqdiff_rowsum_leaves=_leaves.signature(
                           _I64, _I64, _P, _P, _I32))


def _refuse(a: torch.Tensor, b: torch.Tensor, n: int, kk: int,
            device: torch.device) -> None:
    """Raises the error that one (a, b) entry of ``n`` unit rows in a table
    of K = ``kk`` clients on ``device`` deserves."""
    if device.type != "cuda" or a.device != device or b.device != device:
        raise ValueError(f"sqdiff_rowsum kernel needs CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"sqdiff_rowsum kernel takes f32 or bf16 (same for "
                        f"a and b), got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or \
            b.shape[0] != n or a.shape[0] != kk * n:
        raise ValueError(f"sqdiff_rowsum kernel needs a (K·n, C) and b (n, "
                         f"C) with n the unit rows and one K for the table; "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, n={n}, "
                         f"K={kk}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("sqdiff_rowsum kernel needs contiguous inputs")
    raise ValueError(f"sqdiff_rowsum kernel got an empty input "
                     f"{tuple(a.shape)}")


def sqdiff_rowsum_leaves(a: list[torch.Tensor], b: list[torch.Tensor],
                         units: list[tuple[int, int]]) -> torch.Tensor:
    """Launch the kernel once over every leaf (once a chunk of
    ``_leaves.MAX_LEAVES``): the (K, U) f32 per-unit sums
    ``out[k, off_i + j] = Σ_i Σ_c (a[i][k·n_i + j, c] − b[i][j, c])²``,
    each unit's leaves added in list order, starting from 0.

    a[i]: (K·n_i, C_i) and b[i]: (n_i, C_i) CUDA tensors on one device, both
    f32 or both bf16, contiguous, with ``units[i] = (off_i, n_i)`` the
    leaf's first unit and its unit count; K is the same for every leaf and
    U = max(off_i + n_i) (a unit that no leaf covers is 0). Raises on
    anything else, and on a refused launch.
    """
    if not len(a) == len(b) == len(units) or not a:
        raise ValueError(f"sqdiff_rowsum_leaves needs equal, non-empty "
                         f"lists; got {len(a)}, {len(b)}, {len(units)}")
    device = a[0].device
    index = device.index if a[0].is_cuda else None
    kk = (a[0].shape[0] // units[0][1]
          if a[0].dim() == 2 and units[0][1] > 0 else 0)
    num_units = max(off + n for off, n in units)
    desc, blocks = [], []
    for x, y, (off, n) in zip(a, b, units):
        # one chain of cheap attribute tests a leaf; a leaf that fails
        # gets its error from _refuse
        shape = x.shape
        if not (x.get_device() == index and y.get_device() == index
                and x.dtype in _DTYPE_CODES and y.dtype is x.dtype
                and len(shape) == 2 and y.dim() == 2 and off >= 0
                and shape[0] == kk * n and y.shape == (n, shape[1])
                and x.is_contiguous() and y.is_contiguous() and x.numel()):
            _refuse(x, y, n, kk, device)
        rows, cols = shape
        px, py, size = x.data_ptr(), y.data_ptr(), x.element_size()
        width = _leaves.vector_width(cols, ((px, size), (py, size)))
        desc += (px, py, rows, cols, _DTYPE_CODES[x.dtype], width, off)
        blocks.append(_leaves.leaf_blocks(rows, cols, width, per_row=True))
    out = torch.empty((kk, num_units), dtype=torch.float32, device=device)
    # pass 1's partials, one a block; a later chunk reuses them in stream
    # order
    partial = torch.empty(sum(blocks), dtype=torch.float32, device=device)
    lib = _lib()
    _leaves.launch("sqdiff_rowsum", lib, lib.repro_sqdiff_rowsum_leaves,
                   desc, blocks, device, kk, num_units, partial.data_ptr(),
                   out.data_ptr(), pointers=2,
                   chunk_args=lambda chunk: (int(chunk.first == 0),))
    return out


def sqdiff_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over a one-entry table: ``out[r] = Σ_c (a[r,c] −
    b[r % R_b, c])²``.

    a: (R, C) and b: (R_b, C) CUDA tensors on one device, both f32 or both
    bf16, contiguous, with R a multiple of R_b (``b`` is broadcast over
    R / R_b client blocks; R_b = R is the plain 2-D case). Returns (R,)
    float32. Raises on anything else, and on a refused launch.
    """
    if a.ndim != 2 or b.ndim != 2 or b.shape[0] < 1 or \
            a.shape[0] % b.shape[0]:
        raise ValueError(f"sqdiff_rowsum kernel needs a (R, C), b (R_b, C) "
                         f"with R % R_b == 0; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    return sqdiff_rowsum_leaves([a], [b], [(0, b.shape[0])]).reshape(-1)
