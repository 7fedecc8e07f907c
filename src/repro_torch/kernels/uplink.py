"""CUDA kernel launchers: the fused packed-uplink reduction, dequantization
plus the Eq. 5 numerator, over a table of leaves, and with the
error-feedback residual, one leaf a launch.

Replaces the Pallas TPU kernels ``src/repro/kernels/uplink.py``
(``fused_uplink`` / ``_uplink_kernel`` and ``fused_uplink_ef`` /
``_uplink_ef_kernel``). The kernels are ``csrc/uplink.cu``; its header
says what bounds them on the card (bytes, and launches and latency when a
model's leaves are small) and what the one launch over a table of leaves
(``csrc/leaf_table.cuh``) does about that. :func:`fused_uplink_leaves`
covers every leaf of a round in one launch; :func:`fused_uplink`, the TPU
kernel's signature, is the same kernel over a one-entry table. The plain
PyTorch versions are in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _leaves

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = {torch.int8: 4, torch.float32: 16, torch.bfloat16: 8}  # 4 elements
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load(
        "uplink",
        repro_fused_uplink_leaves=_leaves.signature(_I64),
        repro_fused_uplink_ef=[_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                               _I64, _I32, _I32, _I32, _P])


def _check(name: str, levels: torch.Tensor, rowvecs: tuple, mats: tuple,
           outs: tuple) -> tuple[int, int, int, bool]:
    """Device, dtype, shape and contiguity checks shared by both kernels;
    returns (K, R, C, vec)."""
    tensors = (levels, *rowvecs, *mats, *outs)
    if levels.device.type != "cuda" or any(t.device != levels.device
                                           for t in tensors):
        raise ValueError(f"{name} kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if levels.dtype != torch.int8 or \
            any(t.dtype != torch.float32 for t in rowvecs) or \
            any(t.dtype not in _DTYPE_CODES for t in mats):
        raise TypeError(f"{name} kernel takes int8 levels, f32 per-row "
                        "vectors and f32 or bf16 v/e_old; got "
                        f"{[t.dtype for t in (levels, *rowvecs, *mats)]}")
    if levels.ndim != 3:
        raise ValueError(f"{name} kernel needs levels (K, R, C), got "
                         f"{tuple(levels.shape)}")
    kk, rows, cols = levels.shape
    if any(t.shape != (kk, rows) for t in rowvecs) or \
            any(t.shape != levels.shape for t in mats):
        raise ValueError(f"{name} kernel needs (K, R) per-row vectors and "
                         f"(K, R, C) v/e_old for levels {tuple(levels.shape)}"
                         f"; got {[tuple(t.shape) for t in (*rowvecs, *mats)]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if kk == 0 or rows == 0 or cols == 0:
        raise ValueError(f"{name} kernel got an empty input "
                         f"{tuple(levels.shape)}")
    vec = cols % 4 == 0 and all(
        t.data_ptr() % _ALIGN[t.dtype] == 0
        for t in (levels, *mats, *outs))
    return kk, rows, cols, vec


def fused_uplink_leaves(levels: list[torch.Tensor],
                        scales: list[torch.Tensor],
                        ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """Launch the kernel once over every leaf (once a chunk of
    ``_leaves.MAX_LEAVES``): ``num[i] = Σ_k ws[i][k,r]·scales[i][k,r]·
    levels[i][k,r,:]``.

    Each entry as :func:`fused_uplink` takes it, all on one CUDA device
    and with one K. Returns the (R, C) f32 ``num`` of each leaf. Raises on
    anything else, and on a refused launch.
    """
    if not len(levels) == len(scales) == len(ws) or not levels:
        raise ValueError(f"fused_uplink_leaves needs equal, non-empty lists;"
                         f" got {len(levels)}, {len(scales)}, {len(ws)}")
    device = levels[0].device
    index = device.index if levels[0].is_cuda else None
    kk = levels[0].shape[0] if levels[0].dim() == 3 else 0
    nums, desc, blocks = [], [], []
    for lv, s, w in zip(levels, scales, ws):
        # one chain of cheap attribute tests a leaf; a leaf that fails
        # gets its error from _check, or is on another device or K
        shape = lv.shape
        if not (lv.get_device() == index and s.get_device() == index
                and w.get_device() == index and lv.dtype is torch.int8
                and s.dtype is torch.float32 and w.dtype is torch.float32
                and len(shape) == 3 and shape[0] == kk
                and s.shape == shape[:2] and w.shape == shape[:2]
                and lv.is_contiguous() and s.is_contiguous()
                and w.is_contiguous() and lv.numel()):
            _check("fused_uplink", lv, (s, w), (), ())
            raise ValueError(f"fused_uplink_leaves needs one device and one "
                             f"K; got {lv.device}, K={shape[0]} after "
                             f"{device}, K={kk}")
        _, rows, cols = shape
        num = torch.empty((rows, cols), dtype=torch.float32, device=device)
        pl, pn = lv.data_ptr(), num.data_ptr()
        width = _leaves.vector_width(cols, ((pl, 1), (pn, 4)))
        desc += (pl, s.data_ptr(), w.data_ptr(), pn, rows, cols, 0, width)
        blocks.append(_leaves.leaf_blocks(rows, cols, width, per_row=True))
        nums.append(num)
    lib = _lib()
    _leaves.launch("fused_uplink", lib, lib.repro_fused_uplink_leaves, desc,
                   blocks, device, kk)
    return nums


def fused_uplink(levels: torch.Tensor, scales: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over a one-entry table: ``num = Σ_k
    w[k,r]·scales[k,r]·levels[k,r,:]``.

    levels: (K, R, C) int8; scales, w: (K, R) f32; all contiguous CUDA
    tensors on one device. Returns num (R, C) f32. Raises on anything
    else, and on a refused launch.
    """
    return fused_uplink_leaves([levels], [scales], [w])[0]


def fused_uplink_ef(levels: torch.Tensor, scales: torch.Tensor,
                    w: torch.Tensor, gate: torch.Tensor, v: torch.Tensor,
                    e_old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: :func:`fused_uplink`'s ``num`` plus
    ``new_res = gate·(v − recon) + (1 − gate)·e_old``.

    levels: (K, R, C) int8; scales, w, gate: (K, R) f32; v, e_old: (K, R,
    C) f32 or bf16 (each its own); all contiguous CUDA tensors on one
    device. Returns ``(num (R, C), new_res (K, R, C))`` f32. Raises on
    anything else, and on a refused launch.
    """
    num = torch.empty(levels.shape[1:], dtype=torch.float32,
                      device=levels.device)
    res = torch.empty(levels.shape, dtype=torch.float32,
                      device=levels.device)
    kk, rows, cols, vec = _check("fused_uplink_ef", levels,
                                 (scales, w, gate), (v, e_old), (num, res))
    lib = _lib()
    with torch.cuda.device(levels.device):
        code = lib.repro_fused_uplink_ef(
            levels.data_ptr(), scales.data_ptr(), w.data_ptr(),
            gate.data_ptr(), v.data_ptr(), e_old.data_ptr(), num.data_ptr(),
            res.data_ptr(), kk, rows, cols, _DTYPE_CODES[v.dtype],
            _DTYPE_CODES[e_old.dtype], int(vec),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_uplink_ef")
    _build.LAUNCHES["fused_uplink_ef"] += 1
    return num, res
