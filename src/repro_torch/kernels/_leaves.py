"""Host side of the leaf table (``csrc/leaf_table.cuh``): one kernel launch
over every parameter leaf of a model.

:func:`vector_width`, :func:`leaf_blocks` and :func:`plan` are pure
functions of shapes and addresses, so the CPU tests check them:

- a leaf's vector width is 16 or 4 elements a thread when its columns are
  a multiple of it and every pointer is aligned to ``min(16, width ·
  element size)`` bytes, else 1;
- a leaf takes ``ceil(elements / (THREADS · width))`` blocks over the flat
  leaf, or that many a row (``per_row``);
- a list of leaves is cut into chunks of at most ``MAX_LEAVES`` (the 4 KB
  kernel-parameter limit), each with the exclusive prefix sum of its
  leaves' blocks: one launch a chunk.

:func:`launch` passes each chunk's description to the C entry, which
copies it into the by-value kernel parameter, so nothing is staged in a
buffer that a later call could overwrite.
"""
from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Iterable, Sequence

import torch

from repro_torch.kernels import _build

THREADS = 256          # leaf_table.cuh kThreads
MAX_LEAVES = 48        # leaf_table.cuh kMaxLeaves
FIELDS = 8             # leaf_table.cuh kFields: 4 pointers, rows, cols,
                       # dtype, width
WIDTHS = (16, 4)
MAX_BLOCKS = 2**31 - 1     # a grid's x dimension


def signature(*extra) -> list:
    """``argtypes`` of a table entry: ``(desc, starts, n, *extra,
    stream)``."""
    return [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *extra,
            ctypes.c_void_p]


def vector_width(cols: int, operands: Iterable[tuple[int, int]]) -> int:
    """Elements a thread for a leaf of ``cols`` columns whose vector
    operands are ``(address, element bytes)`` pairs: the widest of
    :data:`WIDTHS` that divides ``cols`` and to which every address is
    aligned (``min(16, width · bytes)``), else 1."""
    operands = tuple(operands)
    for width in WIDTHS:
        if cols % width:
            continue
        for addr, size in operands:
            if addr % (width * size if width * size < 16 else 16):
                break
        else:
            return width
    return 1


def leaf_blocks(rows: int, cols: int, width: int, per_row: bool) -> int:
    """Blocks of ``THREADS`` threads, ``width`` elements each, over the
    flat leaf, or over each row on its own when ``per_row``."""
    span = THREADS * width
    if per_row:
        return rows * -(-cols // span)
    return -(-(rows * cols) // span)


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One launch: leaves ``first`` .. ``first + len(starts) - 2`` of the
    list, ``starts`` the exclusive prefix sum of their blocks."""

    first: int
    starts: tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.starts) - 1

    @property
    def stop(self) -> int:
        return self.first + self.n


def plan(blocks: Sequence[int], max_leaves: int = MAX_LEAVES,
         max_blocks: int = MAX_BLOCKS) -> list[Chunk]:
    """Cut leaves of ``blocks`` blocks each into launches of at most
    ``max_leaves`` leaves and ``max_blocks`` blocks, in order."""
    chunks, first, starts = [], 0, [0]
    for i, b in enumerate(blocks):
        if not 1 <= b <= max_blocks:
            raise ValueError(f"leaf {i} needs {b} blocks; a launch takes 1 "
                             f"to {max_blocks}")
        if len(starts) > max_leaves or starts[-1] + b > max_blocks:
            chunks.append(Chunk(first, tuple(starts)))
            first, starts = i, [0]
        starts.append(starts[-1] + b)
    if len(starts) > 1:
        chunks.append(Chunk(first, tuple(starts)))
    return chunks


def launch(name: str, lib: ctypes.CDLL, fn, desc: Sequence[int],
           blocks: Sequence[int], device: torch.device, *args) -> None:
    """One call of the C entry ``fn(desc, starts, n, *args, stream)`` a
    chunk of :func:`plan`; ``desc`` holds ``FIELDS`` ints a leaf. Raises on
    a refused launch; adds one to ``name``'s launch count a launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    for chunk in plan(blocks):
        # host bytes that ctypes passes as pointers; the C entry copies
        # them into the kernel's parameter before it returns
        d = struct.pack(f"{chunk.n * FIELDS}q",
                        *desc[chunk.first * FIELDS:chunk.stop * FIELDS])
        s = struct.pack(f"{chunk.n + 1}i", *chunk.starts)
        if device.index == torch.cuda.current_device():
            code = fn(d, s, chunk.n, *args, stream)
        else:
            with torch.cuda.device(device):
                code = fn(d, s, chunk.n, *args, stream)
        _build.check(lib, code, name)
        _build.LAUNCHES[name] += 1
