"""Transformer LM, port of ``repro.models.transformer`` for the ``dense``
block kind (the ``dense`` and ``vlm`` families).

Parameters keep the reference's key paths, shapes and layouts (dense
weights ``(d_in, d_out)``), so its params cross with
:func:`repro_torch.bridge.params_from_numpy`::

    params = {
      "embed":     {"tok": (V, D)},
      "blocks":    {...leaves stacked (L, ...)},
      "enc_embed": {"proj": (F, D), "norm": (D,)}      (vlm frontend stub)
      "final":     {"norm": (D,) [, "head": (D, V)]},
    }

The reference scans the stacked blocks; here :func:`_run_stack` is a
Python loop over ``l`` that takes each layer's leaves as views
(``tree_stack_index``). The ``moe``, ``ssm``, ``hybrid`` and enc-dec
(``dec``) kinds are not ported yet (ROADMAP Queue 1 item 10) and raise
``NotImplementedError``; the loss and training come with the training
slice.

"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.units import tree_stack_index
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.layers import (init_dense, init_embed, init_mlp,
                                       lora_dense, mlp_fwd, rms_norm)

Pytree = Any
PORTED_KINDS = ("dense",)


def block_kind(cfg: ModelConfig) -> str:
    return {"dense": "dense", "vlm": "dense", "moe": "moe",
            "ssm": "ssm", "hybrid": "hybrid", "audio": "dec"}[cfg.family]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind the port does not
    have yet."""
    kind = block_kind(cfg)
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: the {kind!r} block kind ({cfg.family} family) is "
            "not ported to PyTorch yet (ROADMAP Queue 1 item 10); the port "
            f"runs {PORTED_KINDS} (the dense and vlm families)")


# ======================================================================
# Init
# ======================================================================
def _init_attn(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple):
    dt = dtype_of(cfg.param_dtype)
    d, hd = cfg.d_model, cfg.hd
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": init_dense(gen, d, qdim, dt, device, lead=lead),
        "wk": init_dense(gen, d, kvdim, dt, device, lead=lead),
        "wv": init_dense(gen, d, kvdim, dt, device, lead=lead),
        "wo": init_dense(gen, qdim, d, dt, device, lead=lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", qdim), ("bk", kvdim), ("bv", kvdim)):
            p[name] = torch.zeros((*lead, n), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dt, device=device)
    return p


def _stack_blocks(gen: torch.Generator, cfg: ModelConfig, device,
                  depth: int):
    """A dense block's leaves, each stacked over ``depth`` layers."""
    dt = dtype_of(cfg.param_dtype)
    ones = torch.ones((depth, cfg.d_model), dtype=dt, device=device)
    return {"ln1": ones, "attn": _init_attn(gen, cfg, device, (depth,)),
            "ln2": ones.clone(),
            "mlp": init_mlp(gen, cfg, device, lead=(depth,))}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Pytree:
    """Random weights with the reference's shapes, dtypes and scales
    (normal with std ``1/sqrt(d_in)``, embeddings 0.02, norms 1, biases
    0), drawn on ``generator``'s device and moved to ``device``: give a
    CUDA generator to build a full-width model on the card quickly. The
    numbers differ from the reference's ``jax.random`` draws; parity tests
    carry weights across instead."""
    check_ported(cfg)
    dt = dtype_of(cfg.param_dtype)
    params: Pytree = {
        "embed": {"tok": init_embed(generator, cfg.vocab_size, cfg.d_model,
                                    dt, device)},
        "blocks": _stack_blocks(generator, cfg, device, cfg.num_layers),
        "final": {"norm": torch.ones((cfg.d_model,), dtype=dt,
                                     device=device)},
    }
    if not cfg.tie_embeddings:
        params["final"]["head"] = init_dense(generator, cfg.d_model,
                                             cfg.vocab_size, dt, device)
    if cfg.family == "vlm" and cfg.frontend_dim:
        params["enc_embed"] = {
            "proj": init_dense(generator, cfg.frontend_dim, cfg.d_model, dt,
                               device),
            "norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
    return params


# ======================================================================
# Attention wrapper (projection + qk-norm + rope + attend)
# ======================================================================
def _qkv(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    lora = p.get("lora")
    q = lora_dense(x, p["wq"], lora, "wq")
    k = lora_dense(x, p["wk"], lora, "wk")
    v = lora_dense(x, p["wv"], lora, "wv")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:                       # before RoPE, as the reference
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is not None:
        if cfg.mrope:
            q = attn.apply_mrope(q, positions, cfg.mrope_sections,
                                 cfg.rope_theta)
            k = attn.apply_mrope(k, positions, cfg.mrope_sections,
                                 cfg.rope_theta)
        else:
            q = attn.apply_rope(q, positions, cfg.rope_theta)
            k = attn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attn(p, cfg: ModelConfig, x, positions, *, causal=True):
    """Self-attention over positions ``arange(S)`` (the only positions the
    full-sequence passes use)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = attn.attend(q, k, v, causal=causal, window=cfg.sliding_window,
                    chunk=cfg.attn_chunk, probs_bf16=cfg.attn_probs_bf16)
    return lora_dense(o.reshape(b, s, -1), p["wo"], p.get("lora"), "wo")


# ======================================================================
# Block forward (full sequence)
# ======================================================================
def _block_fwd(blk, cfg: ModelConfig, x, positions):
    h = rms_norm(x, blk["ln1"])
    x = x + _self_attn(blk["attn"], cfg, h, positions)
    h2 = rms_norm(x, blk["ln2"])
    return x + mlp_fwd(blk["mlp"], h2)


def _run_stack(blocks, cfg: ModelConfig, x, positions):
    for l in range(cfg.num_layers):
        x = _block_fwd(tree_stack_index(blocks, l), cfg, x, positions)
    return x


# ======================================================================
# Full forward pass
# ======================================================================
def _positions_for(cfg: ModelConfig, batch: int, seq: int, device,
                   offset: int = 0):
    if cfg.mrope:
        return attn.text_mrope_positions(batch, seq, device) + offset
    return torch.arange(seq, device=device)[None, :].expand(batch, seq) \
        + offset


def _embed_tokens(params, cfg: ModelConfig, tokens, embeddings=None):
    x = params["embed"]["tok"][tokens]
    if embeddings is not None and cfg.family == "vlm":
        # VLM early-fusion stub: add projected patch embeddings to the first
        # S_vis token slots (precomputed by the stubbed vision tower).
        proj = embeddings @ params["enc_embed"]["proj"]
        proj = rms_norm(proj, params["enc_embed"]["norm"])
        x[:, :proj.shape[1], :] += proj.to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final"]["norm"])
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["final"]["head"])
    return x @ head.to(x.dtype)


def forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
            enc_inputs: Optional[torch.Tensor] = None,
            embeddings: Optional[torch.Tensor] = None):
    """Full-sequence forward. tokens: (B, S) int -> logits (B, S, V), aux
    (the MoE balance loss in the reference; 0 for the dense kind)."""
    check_ported(cfg)
    if enc_inputs is not None:
        raise NotImplementedError("enc-dec models are not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens, embeddings)
    pos = _positions_for(cfg, b, s, tokens.device)
    x = _run_stack(params["blocks"], cfg, x, pos)
    return _logits(params, cfg, x), torch.zeros((), device=x.device)
