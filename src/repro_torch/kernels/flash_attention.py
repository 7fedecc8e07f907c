"""CUDA kernel launcher: grouped-query flash attention with causal, sliding
window and pad (``kv_len``) masks.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``). :func:`route` picks one of three
kernels from the dtype and the shape alone::

    route      taken when                            kernel
    decode     Sq <= 16, f32 or bf16, any hd         csrc/flash_attention_decode.cu:
                                                     split-KV, grouped heads
    tc         Sq > 16, bf16, hd 64 or 128           csrc/flash_attention_tc.cu:
                                                     wgmma and TMA
    cuda_core  Sq > 16 and f32 (the exact-f32        csrc/flash_attention.cu
               parity route), or bf16, hd 16, 32

Each source's header says what bounds its route on the card and what the
design does about that. A CUDA call launches its route's kernel or raises:
no route gives way to another or to the plain PyTorch version,
:func:`repro_torch.kernels.ref.flash_attention`, which
:mod:`repro_torch.kernels.ops` takes for CPU tensors only.

Launch counts: ``flash_attention`` counts every launch and
``flash_attention_<route>`` each route's. The kernels have no backward: an
input that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)
DECODE_MAX_SQ = 16
ROUTES = ("decode", "tc", "cuda_core")
# H100 SXM: 132 SMs. The decode plan aims at two blocks an SM.
H100_SMS = 132
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_HEAD = [_P] * 4 + [_I64] * 12
_SIGNATURES = {
    "cuda_core": ("flash_attention", "repro_flash_attention",
                  _HEAD + [_I32] * 10 + [ctypes.c_float, _P]),
    "tc": ("flash_attention_tc", "repro_flash_attention_tc",
           _HEAD + [_I32] * 9 + [ctypes.c_float, _P]),
    "decode": ("flash_attention_decode", "repro_flash_attention_decode",
               _HEAD + [_I32] * 10 + [ctypes.c_float, _P, _I32, _I32, _I32,
                                      _P]),
}
_FNS: dict[str, tuple[ctypes.CDLL, object]] = {}
_SMS: dict[int, int] = {}


def route(dtype: torch.dtype, sq: int, hd: int) -> str:
    """The kernel a call with these query rows, head dim and dtype takes:
    ``"decode"``, ``"tc"`` or ``"cuda_core"`` (the module's table)."""
    if sq <= DECODE_MAX_SQ:
        return "decode"
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tc"
    return "cuda_core"


def decode_tile(hd: int, itemsize: int) -> int:
    """Keys in one K (or V) tile of the decode kernel: 16 KB of rows, at most
    128 (``Tile::kTK`` in ``csrc/flash_attention_decode.cu``)."""
    return min(128, 16384 // (hd * itemsize))


def decode_row_block(rows: int) -> int:
    """Query rows a decode block holds (2, 8 or 16): the smallest that holds
    the ``G * Sq`` rows of one KV head, or 16 and several row blocks."""
    return 2 if rows <= 2 else 8 if rows <= 8 else 16


def decode_plan(blocks: int, k_end: int, tile: int,
                sms: int = H100_SMS) -> tuple[int, int]:
    """``(splits, chunk)``: the visible keys ``[0, k_end)`` in ``splits``
    chunks of ``chunk`` keys (a multiple of ``tile``), with ``blocks``
    blocks (batch · KV heads · row blocks) a split.

    Enough splits that ``blocks · splits >= 2 · sms`` where the keys allow
    (at most one a tile); every split holds at least one key, and
    ``splits · chunk >= k_end``. ``k_end = 0`` is one empty split.
    """
    tiles = -(-k_end // tile)
    if tiles == 0:
        return 1, tile
    want = max(1, -(-2 * sms // blocks))
    chunk = -(-tiles // min(want, tiles)) * tile
    return -(-k_end // chunk), chunk


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        source, entry, argtypes = _SIGNATURES[name]
        lib = _build.load(source, **{entry: argtypes})
        fn = _FNS[name] = (lib, getattr(lib, entry))
    return fn


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) element strides of a (B, S, H, hd) tensor."""
    sb, ss, sh, _ = t.stride()
    return sb, sh, ss


def _check(q, k, v, kv_len):
    tensors = (q, k, v)
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes q, k and v of one "
                        "dtype, f32 or bf16; got "
                        f"{[t.dtype for t in tensors]}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
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
        sb, ss, sh, sd = t.stride()
        if sd != 1 or t.data_ptr() % 16 or (sb * size) % 16 or \
                (ss * size) % 16 or (sh * size) % 16:
            raise ValueError("flash_attention kernel needs a contiguous last "
                             "axis and 16-byte aligned pointers and strides; "
                             f"got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel of :func:`route`. Layouts as
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
    skv, kvh = k.shape[1], k.shape[2]
    name = route(q.dtype, sq, hd)
    lib, fn = _fn(name)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            b, h, h // kvh, sq, skv, kv_len, int(causal), int(window), hd]
    if name != "tc":
        args.append(_DTYPE_CODES[q.dtype])
    args.append(1.0 / math.sqrt(hd))
    if name == "decode":
        rows = h // kvh * sq
        rb = decode_row_block(rows)
        k_end = min(kv_len, sq) if causal else kv_len
        splits, chunk = decode_plan(b * kvh * -(-rows // rb), k_end,
                                    decode_tile(hd, q.element_size()),
                                    _sm_count(q.device))
        # partial (o, m, l) of every split, merged by the same call
        part = torch.empty(b * kvh * splits * rows * (hd + 2),
                           dtype=torch.float32, device=q.device)
        args += [part.data_ptr(), splits, chunk, rb]
    if q.device.index == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"flash_attention ({name} route)")
    _build.LAUNCHES["flash_attention"] += 1
    _build.LAUNCHES[f"flash_attention_{name}"] += 1
