"""Serving path, port of ``repro.models.decode`` for every block kind:
prefill + single-token decode with a ring-buffer KV cache, the SSD's
recurrent state and the encoder-decoder's cross K/V.

- ``init_cache``  — allocate the cache, leaves stacked over layers: K/V
  ring buffers (dense, moe, hybrid, dec), the SSD's raw conv tail
  ``ssm_conv`` (L, B, W-1, di+2n) in the compute dtype and state
  ``ssm_state`` (L, B, H, N, P) in f32 (ssm, hybrid), the cross K/V
  ``cross_k`` / ``cross_v`` (L, B, S_enc, KV, hd) in the compute dtype
  (dec).
- ``prefill``     — forward over the prompt that also fills the cache.
- ``decode_step`` — ONE new token against the cache.

Ring buffer: the KV buffer has ``W`` slots; the token at absolute position
``p`` writes slot ``p mod W``. With ``W = sliding_window`` this is
sliding-window attention; with ``W = seq_len`` an ordinary full cache. Keys
are stored post-RoPE, so decode attention needs only an occupancy mask,
and that mask is always a prefix: ``arange(W) < min(pos + 1, W)``. The
cache keeps ``pos`` as a Python int, so a decode step knows that prefix
(the kernel's ``kv_len``) without reading the device.

A patterned stack (``hybrid_moe``) is not served: every entry point
raises ``NotImplementedError``. A hybrid block attends and runs the SSD on
the same ``ln1`` output and averages the two; an ssm block has no ``ln2``
or MLP; an moe block's feed-forward is ``moe_fwd`` with its balance loss
dropped, its capacity counted over the call's tokens (B·S at prefill, B at
a decode step), as in the reference. A dec block's prefill encodes the
frames once and writes each layer's cross K/V straight into the cache; a
decode step reads them (every frame visible) and never writes them.

Unlike the reference, which returns a new cache, :func:`decode_step`
writes the new token's K/V and SSD conv tail and state into the cache's
buffers in place (a copy of the whole cache per token saved) and returns a
new dict around them.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.units import tree_stack_index
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (_embed_tokens, _ffn, _logits,
                                            _cross_attn, _cross_kv,
                                            _encode, _need_frames,
                                            _positions_for, _qkv,
                                            block_kind)

Pytree = Any


def serving_kind(cfg: ModelConfig) -> str:
    """The kind of every served block; a patterned stack (two kinds of
    layer, ``ModelConfig.attn_period``) is not served."""
    if cfg.attn_period:
        raise NotImplementedError(
            f"{cfg.name}: serving a patterned stack (attention and SSD "
            "layers under two stacked keys) is not implemented; its cache "
            "would hold K/V for the attention layers and SSD state for the "
            "rest")
    return block_kind(cfg)


def cache_window(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               enc_len: int = 0, device="cuda") -> Pytree:
    """Empty cache for ``seq_len`` context (and ``enc_len`` encoder frames
    for an enc-dec model), leaves stacked over layers."""
    dt = dtype_of(cfg.compute_dtype)
    kind = serving_kind(cfg)
    layers = cfg.num_layers
    cache: Pytree = {"pos": 0}
    if kind != "ssm":
        shape = (layers, batch, cache_window(cfg, seq_len),
                 cfg.num_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if kind in ("ssm", "hybrid"):
        sc = ssm_mod.init_ssm_cache(cfg, batch, dt, device)
        cache["ssm_conv"] = sc["conv"].expand(layers, *sc["conv"].shape) \
            .contiguous()
        cache["ssm_state"] = sc["state"].expand(
            layers, *sc["state"].shape).contiguous()
    if cfg.is_encdec:
        shape = (layers, batch, enc_len, cfg.num_kv_heads, cfg.hd)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def prefill(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
            enc_inputs: Optional[torch.Tensor] = None,
            embeddings: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, *,
            flash_attention: Optional[Callable] = None):
    """Forward over the prompt; returns (last-position logits (B, V),
    cache). An enc-dec model needs ``enc_inputs``, (B, S_enc, F) frames.

    ``max_len`` sets the cache capacity (≥ prompt length); when omitted the
    cache is exactly prompt-sized and later decode steps roll the ring
    buffer (oldest entry evicted).
    """
    b, s = tokens.shape
    kind = serving_kind(cfg)
    if cfg.is_encdec:
        enc_inputs = _need_frames(cfg, enc_inputs)
        enc_out = _encode(params, cfg, enc_inputs, flash_attention)
    cache = init_cache(cfg, b, max_len or s, enc_len=0 if enc_inputs is None
                       else enc_inputs.shape[1], device=tokens.device)
    x = _embed_tokens(params, cfg, tokens, embeddings)
    positions = _positions_for(cfg, b, s, tokens.device)
    for l in range(cfg.num_layers):
        blk = tree_stack_index(params["blocks"], l)
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        if kind == "ssm":
            o, sc = ssm_mod.ssd_fwd(blk["ssm"], h, cfg, return_cache=True)
            _store_ssm(cache, l, sc)
            x = x + o
            continue
        q, k, v = _qkv(blk["attn"], cfg, h, positions)
        o = attn.attend(q, k, v, causal=True, window=cfg.sliding_window,
                        flash_attention=flash_attention)
        o = o.reshape(b, s, -1) @ blk["attn"]["wo"]
        # keep the last min(s, w) (post-RoPE) keys/values, ring-aligned so
        # that absolute position p sits in slot p mod w
        w = cache["k"].shape[2]
        if w >= s:
            cache["k"][l, :, :s] = k
            cache["v"][l, :, :s] = v
        else:
            shift = (s - w) % w
            cache["k"][l] = torch.roll(k[:, s - w:], shifts=shift, dims=1)
            cache["v"][l] = torch.roll(v[:, s - w:], shifts=shift, dims=1)
        if kind == "hybrid":
            o2, sc = ssm_mod.ssd_fwd(blk["ssm"], h, cfg, return_cache=True)
            _store_ssm(cache, l, sc)
            o = 0.5 * (o + o2)
        x = x + o
        if kind == "dec":
            # the prompt attends to the K/V as computed (f32 of f32
            # frames); the cache holds them in its dtype
            k, v = _cross_kv(blk["cross"], cfg, enc_out)
            cache["cross_k"][l].copy_(k)
            cache["cross_v"][l].copy_(v)
            x = x + _cross_attn(blk["cross"], cfg,
                                rms_norm(x, blk["ln_cross"], cfg.norm_eps),
                                (k, v), flash_attention)
        x = x + _ffn(blk, cfg, rms_norm(x, blk["ln2"], cfg.norm_eps),
                     kind)[0]
    cache["pos"] = s
    return _logits(params, cfg, x[:, -1, :]), cache


def _store_ssm(cache: Pytree, l: int, sc: dict) -> None:
    """Layer ``l``'s SSD conv tail and state into the stacked buffers."""
    cache["ssm_conv"][l] = sc["conv"]
    cache["ssm_state"][l] = sc["state"]


def _layer_ssm(cache: Pytree, l: int) -> dict:
    return {"conv": cache["ssm_conv"][l], "state": cache["ssm_state"][l]}


def decode_step(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Pytree, *,
                flash_attention: Optional[Callable] = None):
    """One token. tokens: (B, 1) int. Returns (logits (B, V), cache')."""
    b = tokens.shape[0]
    kind = serving_kind(cfg)
    pos = cache["pos"]
    x = _embed_tokens(params, cfg, tokens)
    if kind != "ssm":
        w = cache["k"].shape[2]
        slot, n_valid = pos % w, min(pos + 1, w)
        positions = _positions_for(cfg, b, 1, tokens.device, offset=pos)
    for l in range(cfg.num_layers):
        blk = tree_stack_index(params["blocks"], l)
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        if kind == "ssm":
            o, sc = ssm_mod.ssd_step(blk["ssm"], h, _layer_ssm(cache, l),
                                     cfg)
            _store_ssm(cache, l, sc)
            x = x + o
            continue
        q, k, v = _qkv(blk["attn"], cfg, h, positions)
        ck, cv = cache["k"][l], cache["v"][l]
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        o = attn.attend(q, ck, cv, causal=False, window=0, kv_len=n_valid,
                        flash_attention=flash_attention)
        o = o.reshape(b, 1, -1) @ blk["attn"]["wo"]
        if kind == "hybrid":
            o2, sc = ssm_mod.ssd_step(blk["ssm"], h, _layer_ssm(cache, l),
                                      cfg)
            _store_ssm(cache, l, sc)
            o = 0.5 * (o + o2)
        x = x + o
        if kind == "dec":
            x = x + _cross_attn(blk["cross"], cfg,
                                rms_norm(x, blk["ln_cross"], cfg.norm_eps),
                                (cache["cross_k"][l], cache["cross_v"][l]),
                                flash_attention)
        x = x + _ffn(blk, cfg, rms_norm(x, blk["ln2"], cfg.norm_eps),
                     kind)[0]
    return _logits(params, cfg, x[:, 0, :]), {**cache, "pos": pos + 1}
