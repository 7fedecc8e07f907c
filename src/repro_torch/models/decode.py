"""Serving path, port of ``repro.models.decode`` for the dense block kind:
prefill + single-token decode with a ring-buffer KV cache.

- ``init_cache``  — allocate the cache (K/V ring buffers stacked over
  layers).
- ``prefill``     — forward over the prompt that also fills the cache.
- ``decode_step`` — ONE new token against the cache.

Ring buffer: the KV buffer has ``W`` slots; the token at absolute position
``p`` writes slot ``p mod W``. With ``W = sliding_window`` this is
sliding-window attention; with ``W = seq_len`` an ordinary full cache. Keys
are stored post-RoPE, so decode attention needs only an occupancy mask,
and that mask is always a prefix: ``arange(W) < min(pos + 1, W)``. The
cache keeps ``pos`` as a Python int, so a decode step knows that prefix
(the kernel's ``kv_len``) without reading the device.

Unlike the reference, which returns a new cache, :func:`decode_step`
writes the new token's K/V into the cache's buffers in place (a copy of
the whole cache per token saved) and returns a new dict around them.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.units import tree_stack_index
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.layers import mlp_fwd, rms_norm
from repro_torch.models.transformer import (_embed_tokens, _logits,
                                            _positions_for, _qkv,
                                            check_ported)

Pytree = Any


def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> Pytree:
    """Empty cache for ``seq_len`` context; K/V stacked over layers."""
    check_ported(cfg)
    dt = dtype_of(cfg.compute_dtype)
    shape = (cfg.num_layers, batch, cache_window(cfg, seq_len),
             cfg.num_kv_heads, cfg.hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
            embeddings: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, *,
            flash_attention: Optional[Callable] = None):
    """Forward over the prompt; returns (last-position logits (B, V),
    cache).

    ``max_len`` sets the cache capacity (≥ prompt length); when omitted the
    cache is exactly prompt-sized and later decode steps roll the ring
    buffer (oldest entry evicted).
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, tokens.device)
    w = cache["k"].shape[2]
    x = _embed_tokens(params, cfg, tokens, embeddings)
    positions = _positions_for(cfg, b, s, tokens.device)
    for l in range(cfg.num_layers):
        blk = tree_stack_index(params["blocks"], l)
        h = rms_norm(x, blk["ln1"])
        q, k, v = _qkv(blk["attn"], cfg, h, positions)
        o = attn.attend(q, k, v, causal=True, window=cfg.sliding_window,
                        flash_attention=flash_attention)
        x = x + o.reshape(b, s, -1) @ blk["attn"]["wo"]
        # keep the last min(s, w) (post-RoPE) keys/values, ring-aligned so
        # that absolute position p sits in slot p mod w
        if w >= s:
            cache["k"][l, :, :s] = k
            cache["v"][l, :, :s] = v
        else:
            shift = (s - w) % w
            cache["k"][l] = torch.roll(k[:, s - w:], shifts=shift, dims=1)
            cache["v"][l] = torch.roll(v[:, s - w:], shifts=shift, dims=1)
        x = x + mlp_fwd(blk["mlp"], rms_norm(x, blk["ln2"]))
    cache["pos"] = s
    return _logits(params, cfg, x[:, -1, :]), cache


def decode_step(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Pytree, *,
                flash_attention: Optional[Callable] = None):
    """One token. tokens: (B, 1) int. Returns (logits (B, V), cache')."""
    check_ported(cfg)
    b = tokens.shape[0]
    pos = cache["pos"]
    w = cache["k"].shape[2]
    slot, n_valid = pos % w, min(pos + 1, w)
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions_for(cfg, b, 1, tokens.device, offset=pos)
    for l in range(cfg.num_layers):
        blk = tree_stack_index(params["blocks"], l)
        h = rms_norm(x, blk["ln1"])
        q, k, v = _qkv(blk["attn"], cfg, h, positions)
        ck, cv = cache["k"][l], cache["v"][l]
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        o = attn.attend(q, ck, cv, causal=False, window=0, kv_len=n_valid,
                        flash_attention=flash_attention)
        x = x + o.reshape(b, 1, -1) @ blk["attn"]["wo"]
        x = x + mlp_fwd(blk["mlp"], rms_norm(x, blk["ln2"]))
    return _logits(params, cfg, x[:, 0, :]), {**cache, "pos": pos + 1}
