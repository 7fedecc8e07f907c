"""CUDA kernel launcher: per-row Σ(a−b)², the Eq. 3 inner reduction.

Replaces the Pallas TPU kernel ``src/repro/kernels/divergence.py``
(``sqdiff_rowsum`` / ``_sqdiff_kernel``). The kernel is
``csrc/divergence.cu``; its header says what bounds it on the card (bytes)
and what the two-pass design does about that. The plain PyTorch version is
:func:`repro_torch.kernels.ref.sqdiff_rowsum`; :mod:`repro_torch.kernels.ops`
picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Columns per block of pass 1 (a multiple of the 8-wide bf16 vector).
CHUNK_COLS = 16384
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}   # 16 bytes
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("divergence", repro_sqdiff_rowsum=[
        _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _P])


def sqdiff_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``out[r] = Σ_c (a[r,c] − b[r % R_b, c])²``.

    a: (R, C) and b: (R_b, C) CUDA tensors on one device, both f32 or both
    bf16, contiguous, with R a multiple of R_b (``b`` is broadcast over
    R / R_b client blocks; R_b = R is the plain 2-D case). Returns (R,)
    float32. Raises on anything else, and on a refused launch.
    """
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"sqdiff_rowsum kernel needs CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"sqdiff_rowsum kernel takes f32 or bf16 (same for "
                        f"a and b), got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or \
            b.shape[0] < 1 or a.shape[0] % b.shape[0]:
        raise ValueError(f"sqdiff_rowsum kernel needs a (R, C), b (R_b, C) "
                         f"with R % R_b == 0; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("sqdiff_rowsum kernel needs contiguous inputs")
    rows, cols = a.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"sqdiff_rowsum kernel got an empty input "
                         f"{tuple(a.shape)}")
    nchunks = -(-cols // CHUNK_COLS)
    out = torch.empty(rows, dtype=torch.float32, device=a.device)
    partial = (out if nchunks == 1 else
               torch.empty(rows * nchunks, dtype=torch.float32,
                           device=a.device))
    vec = (cols % _VEC_ELEMS[a.dtype] == 0 and a.data_ptr() % 16 == 0
           and b.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.repro_sqdiff_rowsum(
            a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(),
            rows, b.shape[0], cols, CHUNK_COLS, _DTYPE_CODES[a.dtype],
            int(vec), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "sqdiff_rowsum")
    _build.LAUNCHES["sqdiff_rowsum"] += 1
    return out
