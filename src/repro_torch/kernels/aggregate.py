"""CUDA kernel launcher: ``acc + w[:, None] * x``, the Eq. 5 accumulation.

Replaces the Pallas TPU kernel ``src/repro/kernels/aggregate.py``
(``masked_accumulate`` / ``_macc_kernel``). The kernel is
``csrc/aggregate.cu``; its header says what bounds it on the card (bytes)
and what the vectorised elementwise design does about that. The plain
PyTorch version is :func:`repro_torch.kernels.ref.masked_accumulate`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_X_ALIGN = {torch.float32: 16, torch.bfloat16: 8}   # 4 elements
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("aggregate", repro_masked_accumulate=[
        _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P])


def masked_accumulate(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: ``out = acc + w[:, None] * x``.

    acc: (R, C) f32; x: (R, C) f32 or bf16; w: (R,) f32; all contiguous
    CUDA tensors on one device. ``out=None`` allocates a new (R, C) f32
    result; ``out=acc`` accumulates in place (any other ``out`` must be a
    contiguous (R, C) f32 tensor on the same device). Returns ``out``.
    Raises on anything else, and on a refused launch.
    """
    if out is None:
        out = torch.empty_like(acc)
    tensors = (acc, x, w, out)
    if acc.device.type != "cuda" or any(t.device != acc.device
                                        for t in tensors):
        raise ValueError("masked_accumulate kernel needs CUDA tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if acc.dtype != torch.float32 or out.dtype != torch.float32 or \
            w.dtype != torch.float32 or x.dtype not in _DTYPE_CODES:
        raise TypeError("masked_accumulate kernel takes f32 acc, w and out "
                        f"and f32 or bf16 x; got {acc.dtype}, {w.dtype}, "
                        f"{out.dtype}, {x.dtype}")
    if acc.ndim != 2 or x.shape != acc.shape or out.shape != acc.shape or \
            w.shape != (acc.shape[0],):
        raise ValueError("masked_accumulate kernel needs acc, x, out (R, C) "
                         f"and w (R,); got {tuple(acc.shape)}, "
                         f"{tuple(x.shape)}, {tuple(out.shape)}, "
                         f"{tuple(w.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_accumulate kernel needs contiguous inputs")
    rows, cols = acc.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"masked_accumulate kernel got an empty input "
                         f"{tuple(acc.shape)}")
    vec = (cols % 4 == 0 and acc.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0
           and x.data_ptr() % _X_ALIGN[x.dtype] == 0)
    lib = _lib()
    with torch.cuda.device(acc.device):
        code = lib.repro_masked_accumulate(
            acc.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
            rows, cols, _DTYPE_CODES[x.dtype], int(vec),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "masked_accumulate")
    _build.LAUNCHES["masked_accumulate"] += 1
    return out
