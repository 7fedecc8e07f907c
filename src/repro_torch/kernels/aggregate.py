"""CUDA kernel launcher: ``acc + w[:, None] * x``, the Eq. 5 accumulation,
over a table of leaves.

Replaces the Pallas TPU kernel ``src/repro/kernels/aggregate.py``
(``masked_accumulate`` / ``_macc_kernel``). The kernel is
``csrc/aggregate.cu``; its header says what bounds it on the card (bytes,
and launches when a model's leaves are small) and what the one launch over
a table of leaves (``csrc/leaf_table.cuh``) does about that.
:func:`masked_accumulate_leaves` covers every leaf of a client in one
launch; :func:`masked_accumulate`, the TPU kernel's signature, is the same
kernel over a one-entry table. The plain PyTorch versions are in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks by
the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _leaves

_F32 = torch.float32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    return _build.load("aggregate",
                       repro_masked_accumulate_leaves=_leaves.signature())


def _refuse(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
            out: torch.Tensor, device: torch.device) -> None:
    """Raises the error that one (acc, x, w, out) entry of a table on
    ``device`` deserves."""
    tensors = (acc, x, w, out)
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("masked_accumulate kernel needs CUDA tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if acc.dtype != _F32 or out.dtype != _F32 or w.dtype != _F32 or \
            x.dtype not in _DTYPE_CODES:
        raise TypeError("masked_accumulate kernel takes f32 acc, w and out "
                        f"and f32 or bf16 x; got {acc.dtype}, {w.dtype}, "
                        f"{out.dtype}, {x.dtype}")
    if acc.ndim != 2 or x.shape != acc.shape or out.shape != acc.shape or \
            w.shape != acc.shape[:1]:
        raise ValueError("masked_accumulate kernel needs acc, x, out (R, C) "
                         f"and w (R,); got {tuple(acc.shape)}, "
                         f"{tuple(x.shape)}, {tuple(out.shape)}, "
                         f"{tuple(w.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_accumulate kernel needs contiguous inputs")
    raise ValueError(f"masked_accumulate kernel got an empty input "
                     f"{tuple(acc.shape)}")


def _launch(entries) -> None:
    """The kernel over (acc, x, w, out) entries, one launch a chunk of the
    table. The checks run once a leaf, as one chain of cheap attribute
    tests; the first entry that fails gets its error from
    :func:`_refuse`."""
    device = entries[0][0].device
    index = device.index if entries[0][0].is_cuda else None
    desc, blocks = [], []
    for acc, x, w, out in entries:
        shape = acc.shape
        if not (acc.get_device() == index and x.get_device() == index
                and w.get_device() == index and out.get_device() == index
                and acc.dtype is _F32 and out.dtype is _F32
                and w.dtype is _F32 and x.dtype in _DTYPE_CODES
                and len(shape) == 2 and x.shape == shape
                and out.shape == shape and w.shape == shape[:1]
                and acc.is_contiguous() and x.is_contiguous()
                and w.is_contiguous() and out.is_contiguous()
                and acc.numel()):
            _refuse(acc, x, w, out, device)
        rows, cols = shape
        pa, px, po = acc.data_ptr(), x.data_ptr(), out.data_ptr()
        width = _leaves.vector_width(cols, ((pa, 4), (px, x.element_size()),
                                            (po, 4)))
        desc += (pa, px, w.data_ptr(), po, rows, cols, _DTYPE_CODES[x.dtype],
                 width)
        blocks.append(_leaves.leaf_blocks(rows, cols, width, per_row=False))
    lib = _lib()
    _leaves.launch("masked_accumulate", lib,
                   lib.repro_masked_accumulate_leaves, desc, blocks, device)


def masked_accumulate_leaves(accs: list[torch.Tensor],
                             xs: list[torch.Tensor],
                             ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """Launch the kernel once over every leaf (once a chunk of
    ``_leaves.MAX_LEAVES``): ``accs[i] += ws[i][:, None] * xs[i]`` in place.

    Each entry as :func:`masked_accumulate` takes it, all on one CUDA
    device. Returns ``accs``. Raises on anything else, and on a refused
    launch.
    """
    if not len(accs) == len(xs) == len(ws) or not accs:
        raise ValueError(f"masked_accumulate_leaves needs equal, non-empty "
                         f"lists; got {len(accs)}, {len(xs)}, {len(ws)}")
    _launch(list(zip(accs, xs, ws, accs)))
    return accs


def masked_accumulate(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel over a one-entry table: ``out = acc + w[:, None] *
    x``.

    acc: (R, C) f32; x: (R, C) f32 or bf16; w: (R,) f32; all contiguous
    CUDA tensors on one device. ``out=None`` allocates a new (R, C) f32
    result; ``out=acc`` accumulates in place (any other ``out`` must be a
    contiguous (R, C) f32 tensor on the same device). Returns ``out``.
    Raises on anything else, and on a refused launch.
    """
    if out is None:
        out = torch.empty_like(acc)
    _launch([(acc, x, w, out)])
    return out
