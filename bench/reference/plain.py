"""Products in a stated precision, for the references.

``"f32"`` multiplies f32 operands with f32 products and sums (TF32 off).
``"tf32"`` is the check's control, the precision a later change might be
tempted by: every operand of a matrix product or convolution is first
rounded to TF32 (10 mantissa bits, to nearest, ties to even), as the tensor
cores' TF32 path rounds its inputs, and then multiplied in f32. The
rounding passes gradients straight through, so the backward products see
the rounded operands too. Rounding explicitly gives the same control on the
card and on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32")


def full_f32() -> None:
    """TF32 off for every f32 product PyTorch runs in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to 10 mantissa bits, to nearest, ties to even
    (finite inputs); no gradient."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


def _operands(prec: str, *xs):
    if prec == "f32":
        return xs
    if prec == "tf32":
        return tuple(x + (to_tf32(x) - x).detach() for x in xs)
    raise ValueError(f"precision {prec!r} (known: {PRECISIONS})")


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    a, b = _operands(prec, a, b)
    return a @ b


def conv2d(x: torch.Tensor, w: torch.Tensor, prec: str,
           padding: int) -> torch.Tensor:
    """PyTorch's own convolution (im2col and a GEMM), not cuDNN's: cuDNN
    picks its algorithm by shape, and its rounding, near a ReLU or
    max-pool kink, moves a weight gradient by up to percents, far above the
    f32 rounding the check has to see past."""
    x, w = _operands(prec, x, w)
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        return F.conv2d(x, w, padding=padding)
    finally:
        torch.backends.cudnn.enabled = before
