"""CUDA kernel launcher: grouped-query flash attention with causal, sliding
window and pad (``kv_len``) masks.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``). The kernel is
``csrc/flash_attention.cu``; its header says what bounds it on the card and
what the design does about that. The plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_attention`;
:mod:`repro_torch.kernels.ops` picks by the tensor's device.

The kernel has no backward: an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load(
        "flash_attention",
        repro_flash_attention=[_P, _P, _P, _P, *[_I64] * 12, *[_I32] * 10,
                               ctypes.c_float, _P])


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) element strides of a (B, S, H, hd) tensor."""
    sb, ss, sh, _ = t.stride()
    return sb, sh, ss


def _check(q, k, v, kv_len):
    tensors = (q, k, v)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors):
        raise TypeError("flash_attention kernel takes q, k and v of one "
                        "dtype, f32 or bf16; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("flash_attention kernel has no backward; call it "
                           "on tensors that do not require grad")
    b, sq, h, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or \
            k.shape[3] != hd or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError("flash_attention kernel needs k and v (B, Skv, KV, "
                         f"hd) with H % KV == 0 for q {tuple(q.shape)}; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    skv = k.shape[1]
    if b * h == 0 or sq == 0 or skv == 0:
        raise ValueError("flash_attention kernel got an empty input "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel takes B·H <= 65535, got "
                         f"{b * h}")
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_attention kernel needs 0 <= kv_len <= Skv "
                         f"= {skv}, got {kv_len}")
    size = q.element_size()
    for t in tensors:
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s * size % 16 for s in t.stride()[:3]):
            raise ValueError("flash_attention kernel needs a contiguous last "
                             "axis and 16-byte aligned pointers and strides; "
                             f"got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel. Layouts as
    :func:`repro_torch.kernels.ref.flash_attention`:

    - q (BH, Sq, hd), k and v (BKV, Skv, hd), row ``bh`` reads KV row
      ``bh // G``;
    - q (B, Sq, H, hd), k and v (B, Skv, KV, hd), head ``h`` reads KV head
      ``h // G``; any strides with a contiguous last axis (views of the
      model's projections need no copy).

    q, k and v are CUDA tensors of one dtype (f32 or bf16) that do not
    require grad; hd is 16, 32, 64 or 128; ``0 <= kv_len <= Skv`` (default
    Skv). Returns q's shape in q.dtype. Raises on anything else, and on a
    refused launch.
    """
    if q.ndim == 3:
        bh, sq, hd = q.shape
        bkv = k.shape[0]
        if k.ndim != 3 or bkv < 1 or bh % bkv:
            raise ValueError("flash_attention kernel needs k and v (BKV, "
                             f"Skv, hd) with BH % BKV == 0; got q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}")
        if not (q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("flash_attention kernel needs contiguous "
                             "(BH, Sq, hd) / (BKV, Skv, hd) inputs")
        g = bh // bkv
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        # (BH, S, hd) is (B=BKV, S, H=G, hd) with a single KV head per batch
        _launch(q.view(bkv, g, sq, hd).transpose(1, 2), k.unsqueeze(2),
                v.unsqueeze(2), out.view(bkv, g, sq, hd).transpose(1, 2),
                causal, window, kv_len)
        return out
    if q.ndim != 4:
        raise ValueError("flash_attention kernel takes q (BH, Sq, hd) or "
                         f"(B, Sq, H, hd), got {tuple(q.shape)}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, window, kv_len)
    return out


def _launch(q, k, v, out, causal, window, kv_len):
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    b, sq, h, hd = q.shape
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            b, h, h // k.shape[2], sq, k.shape[1], kv_len, int(causal),
            int(window), hd, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
