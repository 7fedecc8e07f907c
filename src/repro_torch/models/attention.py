"""Attention substrate, port of ``repro.models.attention``: GQA, RoPE /
M-RoPE, the masked single block and the chunked online softmax, behind one
entry point :func:`attend`.

On a CUDA tensor :func:`attend` runs the flash-attention kernel
(``kernels/flash_attention.py``, three routes) for the two masks the
serving path uses, and raises ``NotImplementedError`` for any other. It
goes through the kernel's differentiable form
:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn` (training,
under ``torch.func.grad`` and ``vmap``, and inside the recompute of
``remat_blocks``, whose forward runs without grad mode) except under
``torch.inference_mode`` (serving), where it launches the same kernel
directly: that saves the Function's host cost on the host-paced decode
step (``chip_smoke.py`` phase 13 times both; PERF.md). The masks:

- causal over positions ``arange(S)`` (``q_pos`` and ``kv_pos`` left
  ``None``), with an optional sliding ``window``: prefill and ``forward``;
- non-causal with ``window=0`` over the first ``kv_len`` keys: a decode step
  over its KV ring buffer, whose filled slots are always a prefix, and an
  enc-dec model's encoder and cross-attention (every key visible).

Both are decided from Python ints and flags, so no tensor is read back per
layer. On the CPU :func:`attend` follows the reference's two branches
(``_attend_block`` up to ``flash_threshold`` keys, ``_attend_flash`` past
it) on the same masks, built from the same arguments.

GQA keeps the reference's head order: query head ``h = kv·G + g`` reads KV
head ``kv = h // G``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttentionFn

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Rotary embeddings
# ----------------------------------------------------------------------
def _inv_freq(hd: int, theta: float, device) -> torch.Tensor:
    half = hd // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotation (not interleaved), in f32, cast back."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    ang = positions.float()[..., None] * _inv_freq(hd, theta, x.device)
    return _rotate(x, torch.cos(ang)[:, :, None, :],
                   torch.sin(ang)[:, :, None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float):
    """Qwen2-VL multimodal RoPE. positions: (3, B, S) = (t, h, w) ids; the
    hd/2 frequency slots are split into ``sections``, each rotated by its
    own position stream."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    inv = _inv_freq(hd, theta, x.device)
    angs, off = [], 0
    for axis, sec in enumerate(sections):
        angs.append(positions[axis].float()[..., None] * inv[off:off + sec])
        off += sec
    ang = torch.cat(angs, dim=-1)[:, :, None, :]           # (B, S, 1, hd/2)
    return _rotate(x, torch.cos(ang), torch.sin(ang))


def text_mrope_positions(batch: int, seq: int, device="cuda") -> torch.Tensor:
    """Text-only M-RoPE positions: t = h = w = arange (matches HF)."""
    p = torch.arange(seq, device=device)[None, :].expand(batch, seq)
    return torch.stack([p, p, p], dim=0)


# ----------------------------------------------------------------------
# Masked single-block attention (short KV path, CPU)
# ----------------------------------------------------------------------
def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int,
               kv_valid: Optional[torch.Tensor] = None):
    """Additive bias (..., Sq, Skv) from position constraints (float32)."""
    ok = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    bias = torch.where(ok, 0.0, NEG_INF).float()
    if kv_valid is not None:  # (B, Skv) bool
        bias = bias[None] + torch.where(kv_valid, 0.0, NEG_INF)[:, None, :]
    return bias


def _attend_block(q, k, v, bias):
    """q: (B,Sq,KV,G,hd); k,v: (B,Skv,KV,hd); bias: (B?,Sq,Skv) fp32."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    s = torch.einsum("bqkgd,bckd->bkgqc", q.float(), k.float()) * scale
    if bias.ndim == 2:
        bias = bias[None]
    s = s + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqc,bckd->bqkgd", p, v.float())


# ----------------------------------------------------------------------
# Chunked online-softmax attention (long KV path, CPU)
# ----------------------------------------------------------------------
def _attend_flash(q, k, v, q_pos, kv_pos, *, causal, window, chunk,
                  kv_valid=None, probs_bf16=False):
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    nchunks = -(-skv // chunk)
    pad = nchunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=2**30)
        if kv_valid is not None:
            kv_valid = torch.nn.functional.pad(kv_valid, (0, pad))
    if kv_valid is None:
        kv_valid = torch.ones((b, nchunks * chunk), dtype=torch.bool,
                              device=q.device)
    kv_valid = kv_valid & (kv_pos[None, :] < 2**30)

    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full((b, kvh, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, g, sq), device=q.device)
    o = torch.zeros((b, kvh, g, sq, hd), device=q.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb, vb, pb, valb = k[:, sl], v[:, sl], kv_pos[sl], kv_valid[:, sl]
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb.float()) * scale
        ok = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (pb[None, :] <= q_pos[:, None])
        if window > 0:
            ok = ok & (pb[None, :] > q_pos[:, None] - window)
        bias = torch.where(ok, 0.0, NEG_INF)
        bias = bias[None] + torch.where(valb, 0.0, NEG_INF)[:, None, :]
        s = s + bias[:, None, None, :, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked blocks: exp(s - m) would be exp(0) = 1 with
        # m == s == NEG_INF; force those probabilities and corrections
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        p = torch.where(s <= NEG_INF / 2, 0.0,
                        torch.exp(s - m_new[..., None]))
        l = l * corr + p.sum(dim=-1)
        if probs_bf16:
            # bf16 operands, f32 products and sums (bf16 x bf16 is exact
            # in f32), as the reference's preferred_element_type=f32
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.bfloat16().float(),
                              vb.bfloat16().float())
        else:
            pv = torch.einsum("bkgqc,bckd->bkgqd", p, vb.float())
        o = o * corr[..., None] + pv
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4)  # (B,Sq,KV,G,hd)


# ----------------------------------------------------------------------
# Public entry point
# ----------------------------------------------------------------------
def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_pos: Optional[torch.Tensor] = None,
           kv_pos: Optional[torch.Tensor] = None,
           causal: bool = True, window: int = 0,
           kv_valid: Optional[torch.Tensor] = None,
           kv_len: Optional[int] = None,
           chunk: int = 1024, flash_threshold: int = 2048,
           probs_bf16: bool = False,
           flash_attention: Optional[Callable] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); H = KV·G.
    q_pos: (Sq,) and kv_pos: (Skv,) absolute positions, ``None`` for
    ``arange``. kv_valid: optional (B, Skv) bool occupancy; ``kv_len``
    (a Python int) says the same for a filled prefix, ``arange(Skv) <
    kv_len``. Returns (B, Sq, H, hd) in q.dtype.

    On CUDA only the kernel's masks are taken (see the module docstring);
    ``flash_attention`` replaces the kernel there with a function of the
    same signature, called directly (for example the plain
    :func:`repro_torch.kernels.ref.flash_attention`, to hold the kernel to
    it: its gradient is then autograd's). ``chunk``, ``flash_threshold``
    choose the CPU branch.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    assert h % kvh == 0, (h, kvh)
    if q.device.type == "cuda":
        positional = causal or window > 0
        if kv_valid is not None or probs_bf16 or (
                positional and (q_pos is not None or kv_pos is not None)):
            raise NotImplementedError(
                "attend on CUDA runs the flash-attention kernel, which takes "
                "causal/window masks over arange positions or a filled "
                "prefix kv_len; got explicit positions, a kv_valid mask or "
                "probs_bf16")
        if flash_attention is not None:
            return flash_attention(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)
        if torch.is_inference_mode_enabled():
            return ops.flash_attention(q, k, v, causal=causal,
                                       window=window, kv_len=kv_len)
        return FlashAttentionFn.apply(q, k, v, causal, window, kv_len)
    skv = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)
    if kv_len is not None:
        kv_valid = (torch.arange(skv, device=q.device) < kv_len)[None, :] \
            .expand(b, skv)
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    if skv <= flash_threshold:
        bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                          kv_valid=kv_valid)
        o = _attend_block(qg, k, v, bias)
    else:
        o = _attend_flash(qg, k, v, q_pos, kv_pos, causal=causal,
                          window=window, chunk=chunk, kv_valid=kv_valid,
                          probs_bf16=probs_bf16)
    return o.reshape(b, sq, h, hd).to(q.dtype)
