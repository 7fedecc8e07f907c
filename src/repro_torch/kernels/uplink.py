"""CUDA kernel launchers: the fused packed-uplink reduction, dequantization
plus the Eq. 5 numerator, without and with the error-feedback residual,
each over a table of leaves.

Replaces the Pallas TPU kernels ``src/repro/kernels/uplink.py``
(``fused_uplink`` / ``_uplink_kernel`` and ``fused_uplink_ef`` /
``_uplink_ef_kernel``). The kernels are ``csrc/uplink.cu``; its header
says what bounds them on the card (bytes, and launches and latency when a
model's leaves are small) and what the one launch over a table of leaves
(``csrc/leaf_table.cuh``) does about that. :func:`fused_uplink_leaves` and
:func:`fused_uplink_ef_leaves` cover every leaf of a round in one launch;
:func:`fused_uplink` and :func:`fused_uplink_ef`, the TPU kernels'
signatures, are the same kernels over a one-entry table. The plain PyTorch
versions are in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _leaves

_F32 = torch.float32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
EF_WIDTHS = (8, 4)          # uplink.cu ef_width: columns a thread
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    return _build.load(
        "uplink",
        repro_fused_uplink_leaves=_leaves.signature(_I64),
        repro_fused_uplink_ef_leaves=_leaves.signature(_I64, _I64, _P, _P,
                                                       _P))


def _check(name: str, levels: torch.Tensor, rowvecs: tuple,
           mats: tuple) -> None:
    """Device, dtype, shape and contiguity checks shared by both kernels;
    raises on the first that fails."""
    tensors = (levels, *rowvecs, *mats)
    if levels.device.type != "cuda" or any(t.device != levels.device
                                           for t in tensors):
        raise ValueError(f"{name} kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if levels.dtype != torch.int8 or \
            any(t.dtype != _F32 for t in rowvecs) or \
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
            _check("fused_uplink", lv, (s, w), ())
            raise ValueError(f"fused_uplink_leaves needs one device and one "
                             f"K; got {lv.device}, K={shape[0]} after "
                             f"{device}, K={kk}")
        _, rows, cols = shape
        num = torch.empty((rows, cols), dtype=torch.float32, device=device)
        pl, pn = lv.data_ptr(), num.data_ptr()
        width = _leaves.vector_width(cols, ((pl, 1), (pn, 4)))
        desc += (pl, s.data_ptr(), w.data_ptr(), pn, rows, cols, 0, width, 0)
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


def fused_uplink_ef_leaves(levels: list[torch.Tensor],
                           v: list[torch.Tensor], e_old: list[torch.Tensor],
                           units: list[tuple[int, int]],
                           scales: torch.Tensor, w: torch.Tensor,
                           gate: torch.Tensor
                           ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Launch the kernel once over every leaf (once a chunk of
    ``_leaves.MAX_LEAVES``): each leaf's :func:`fused_uplink_ef`, with its
    (K, n) scales, weights and gates read from the round's shared (K, U)
    matrices at the leaf's units.

    levels[i]: (K, n_i, C_i) int8; v[i], e_old[i]: (K, n_i, C_i) f32 or
    bf16 (each its own); ``units[i] = (off_i, n_i)``, the leaf's rows being
    units off_i .. off_i + n_i − 1; scales, w, gate: (K, U) f32 with
    off_i + n_i <= U; all contiguous CUDA tensors on one device with one K.
    Returns each leaf's ``(num (n_i, C_i), new_res (K, n_i, C_i))`` f32.
    Raises on anything else, and on a refused launch.
    """
    if not len(levels) == len(v) == len(e_old) == len(units) or not levels:
        raise ValueError(f"fused_uplink_ef_leaves needs equal, non-empty "
                         f"lists; got {len(levels)}, {len(v)}, {len(e_old)}, "
                         f"{len(units)}")
    device = levels[0].device
    shared = (scales, w, gate)
    if device.type != "cuda" or any(t.device != device for t in shared):
        raise ValueError(f"fused_uplink_ef kernel needs CUDA tensors on one "
                         f"device, got {device} and "
                         f"{[str(t.device) for t in shared]}")
    if any(t.dtype != _F32 or t.dim() != 2 or t.shape != scales.shape
           or not t.is_contiguous() for t in shared):
        raise ValueError("fused_uplink_ef kernel needs contiguous (K, U) f32 "
                         f"scales, w and gate; got "
                         f"{[(t.dtype, tuple(t.shape)) for t in shared]}")
    kk, num_units = scales.shape
    index = device.index
    out, desc, blocks = [], [], []
    for lv, vv, ee, (off, n) in zip(levels, v, e_old, units):
        # one chain of cheap attribute tests a leaf; a leaf that fails
        # gets its error from _check, or is on another K or unit
        shape = lv.shape
        if not (lv.get_device() == index and vv.get_device() == index
                and ee.get_device() == index and lv.dtype is torch.int8
                and vv.dtype in _DTYPE_CODES and ee.dtype in _DTYPE_CODES
                and len(shape) == 3 and shape[0] == kk and shape[1] == n
                and vv.shape == shape and ee.shape == shape
                and 0 <= off and off + n <= num_units
                and lv.is_contiguous() and vv.is_contiguous()
                and ee.is_contiguous() and lv.numel()):
            _check("fused_uplink_ef", lv, (), (vv, ee))
            raise ValueError(f"fused_uplink_ef_leaves needs levels (K, n, "
                             f"C) at units off .. off + n - 1 < U of the "
                             f"(K, U) = ({kk}, {num_units}) scales; got "
                             f"{tuple(shape)} at units ({off}, {n})")
        _, rows, cols = shape
        num = torch.empty((rows, cols), dtype=_F32, device=device)
        res = torch.empty(shape, dtype=_F32, device=device)
        pl, pv, pe = lv.data_ptr(), vv.data_ptr(), ee.data_ptr()
        pn, pr = num.data_ptr(), res.data_ptr()
        width = _leaves.vector_width(
            cols, ((pl, 1), (pv, vv.element_size()), (pe, ee.element_size()),
                   (pn, 4), (pr, 4)), EF_WIDTHS)
        desc += (pl, pv, pe, pn, pr, rows, cols,
                 _DTYPE_CODES[vv.dtype] + 2 * _DTYPE_CODES[ee.dtype], width,
                 off)
        blocks.append(_leaves.leaf_blocks(rows, cols, width, per_row=True))
        out.append((num, res))
    lib = _lib()
    _leaves.launch("fused_uplink_ef", lib, lib.repro_fused_uplink_ef_leaves,
                   desc, blocks, device, kk, num_units, scales.data_ptr(),
                   w.data_ptr(), gate.data_ptr(), pointers=5)
    return out


def fused_uplink_ef(levels: torch.Tensor, scales: torch.Tensor,
                    w: torch.Tensor, gate: torch.Tensor, v: torch.Tensor,
                    e_old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel over a one-entry table: :func:`fused_uplink`'s
    ``num`` plus ``new_res = gate·(v − recon) + (1 − gate)·e_old``.

    levels: (K, R, C) int8; scales, w, gate: (K, R) f32; v, e_old: (K, R,
    C) f32 or bf16 (each its own); all contiguous CUDA tensors on one
    device. Returns ``(num (R, C), new_res (K, R, C))`` f32. Raises on
    anything else, and on a refused launch.
    """
    _check("fused_uplink_ef", levels, (scales, w, gate), (v, e_old))
    return fused_uplink_ef_leaves([levels], [v], [e_old],
                                  [(0, levels.shape[1])], scales, w, gate)[0]
