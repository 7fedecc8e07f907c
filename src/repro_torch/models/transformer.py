"""Transformer LM, port of ``repro.models.transformer`` for every block
kind: ``dense`` (the ``dense`` and ``vlm`` families), ``moe`` (routed
experts in place of the MLP), ``ssm`` (Mamba-2, attention-free), ``hybrid``
(attention ∥ SSD in every block), ``enc`` / ``dec`` (the ``audio``
family's encoder-decoder), and the ``hybrid_moe`` family's two kinds,
``moe`` and ``ssm_moe``, in a pattern.

Parameters keep the reference's key paths, shapes and layouts (dense
weights ``(d_in, d_out)``), so its params cross with
:func:`repro_torch.bridge.params_from_numpy`::

    params = {
      "embed":      {"tok": (V, D)},
      "blocks":     {...leaves stacked (L, ...)},
      "enc_blocks": {...leaves stacked (L_enc, ...)}  (enc-dec only)
      "enc_embed":  {"proj": (F, D), "norm": (D,)}    (audio, vlm stubs)
      "final":      {"norm": (D,) [, "head": (D, V)]},
    }

A patterned stack (``ModelConfig.attn_period``, the ``hybrid_moe``
family) keeps its attention layers under a second stacked key,
``"attn_blocks"`` (kind ``moe``), and its Mamba-2 layers under
``"blocks"`` (kind ``ssm_moe``); :func:`stack_layers` unbinds both once
and interleaves their layers in the pattern's order, and
``core.units`` gives each layer of either key a FedLDF unit.

The reference scans the stacked blocks; here :func:`_run_stack` is a
Python loop over the layers, whose leaves are views from unbinding each
stacked leaf once a forward (``tree_unbind``; the decoder's cross K/V
projections read the same views): autograd then writes a stacked leaf's
gradient once, as one ``stack`` of its layers' gradients, where a slice
a layer would fill a full-size zero gradient for each and add the L of
them. ``ModelConfig.remat_blocks`` (the reference's
``jax.checkpoint`` around each block) wraps each block in
:class:`_RecomputeBlock`, an ``autograd.Function`` that keeps only the
block's inputs and recomputes the block in the backward pass; it works
under ``torch.func.grad`` and ``vmap``, where ``torch.utils.checkpoint``
does not (saved-tensor hooks, and a Function without ``setup_context``,
are refused there).

:func:`lm_loss` / :func:`make_lm_loss` are the training objective of the
federated fine-tuning path (``FLConfig(partition=lora_partition(...))``).
On the card the attention of every pass, training included, is the flash
attention kernel (``models/attention.py``); ``flash_attention=`` replaces
it with a plain function of the same signature.

A block of each kind (the reference's ``_init_block`` / ``_block_fwd``):

    dense:  x + attn(ln1(x)), then + mlp(ln2(x))
    moe:    x + attn(ln1(x)), then + moe(ln2(x))   (no mlp; aux the
            experts' balance loss, summed over the layers in f32)
    ssm:    x + ssd(ln1(x))                        (no ln2, no mlp)
    ssm_moe: x + ssd(ln1(x)), then + moe(ln2(x))
    hybrid: x + 0.5·(attn(h) + ssd(h)), h = ln1(x), then + mlp(ln2(x))
    enc:    x + attn(ln1(x)) non-causal, then + mlp(ln2(x))
    dec:    x + attn(ln1(x)), then + cross(ln_cross(x), enc_kv), then
            + mlp(ln2(x))

A block returns ``(x, aux)``, aux 0 in f32 for the kinds without experts.
granite-4.0-h's μP multipliers and attention are options of the same
blocks: each residual branch is scaled by ``residual_multiplier``, the
embedding by ``embedding_multiplier``, the logits divided by
``logits_scaling``; ``nope`` leaves q and k unrotated, and a non-zero
``attention_multiplier`` scales the scores in place of 1/√hd (q is
multiplied by ``attention_multiplier·√hd`` before :func:`attend`, which
applies 1/√hd, so every route of the kernel serves it unchanged). At their
defaults (1, 1, 1, off, 0) no operation is added.
An enc-dec model encodes its frames once (:func:`_encode`: the frontend
stub's projection, then the ``enc`` stack), projects each decoder layer's
cross K/V from the encoder's output once (:func:`_enc_kv_all`), and its
``dec`` blocks attend to them with plain projections (no bias, qk-norm,
RoPE or LoRA; :func:`_cross_attn`). The frames follow jnp's promotion,
as in the reference: frames wider than the compute dtype (f32 into a bf16
model) run the encoder and the cross K/V projections in the wider dtype,
with the weights cast up (exact), since ``f32 @ bf16`` is an error in
PyTorch; a decoder layer's cross-attention of its q over the wider K/V
runs in that dtype and returns q's, as the reference's ``attend`` does.
Frames in the compute dtype, or narrower, are cast to it.

"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core.partition import leaf_paths, tree_from_paths
from repro_torch.core.units import tree_map, tree_unbind
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.layers import (init_dense, init_embed, init_mlp,
                                       lora_dense, mlp_fwd, rms_norm)

Pytree = Any


def block_kind(cfg: ModelConfig) -> str:
    """The kind of every block of ``params["blocks"]``."""
    return {"dense": "dense", "vlm": "dense", "moe": "moe",
            "ssm": "ssm", "hybrid": "hybrid", "hybrid_moe": "ssm_moe",
            "audio": "dec"}[cfg.family]


ATTN_BLOCKS = "attn_blocks"     # a patterned stack's attention layers


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Each layer's kind in order: a patterned stack's attention layers
    are ``moe`` blocks, the rest of its kind (``block_kind``)."""
    kind = block_kind(cfg)
    if not cfg.attn_period:
        return [kind] * cfg.num_layers
    return ["moe" if cfg.is_attention_layer(i) else kind
            for i in range(cfg.num_layers)]


# ======================================================================
# Init
# ======================================================================
def _init_attn(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple,
               cross: bool = False):
    """One attention's projections, biases and qk-norm scales. A cross
    attention has no qk-norm scales; it keeps the biases, which it never
    reads, as the reference does."""
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
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dt, device=device)
    return p


def _stack_blocks(gen: torch.Generator, cfg: ModelConfig, device,
                  kind: str, depth: int):
    """A ``kind`` block's leaves, each stacked over ``depth`` layers, with
    the reference's key paths."""
    dt = dtype_of(cfg.param_dtype)
    lead = (depth,)
    p: dict = {"ln1": torch.ones((depth, cfg.d_model), dtype=dt,
                                 device=device)}
    if kind not in ("ssm", "ssm_moe"):
        p["attn"] = _init_attn(gen, cfg, device, lead)
    if kind in ("ssm", "hybrid", "ssm_moe"):
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device, lead)
    if kind == "ssm":
        return p
    if kind == "dec":
        p["ln_cross"] = torch.ones((depth, cfg.d_model), dtype=dt,
                                   device=device)
        p["cross"] = _init_attn(gen, cfg, device, lead, cross=True)
    p["ln2"] = torch.ones((depth, cfg.d_model), dtype=dt, device=device)
    if kind in ("moe", "ssm_moe"):
        p["moe"] = moe_mod.init_moe(gen, cfg, device, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, device, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Pytree:
    """Random weights with the reference's shapes, dtypes and scales
    (normal with std ``1/sqrt(d_in)``, embeddings 0.02, norms 1, biases
    0), drawn on ``generator``'s device and moved to ``device``: give a
    CUDA generator to build a full-width model on the card quickly. The
    numbers differ from the reference's ``jax.random`` draws; parity tests
    carry weights across instead."""
    dt = dtype_of(cfg.param_dtype)
    n_attn = cfg.num_attention_layers
    params: Pytree = {
        "embed": {"tok": init_embed(generator, cfg.vocab_size, cfg.d_model,
                                    dt, device)},
        "blocks": _stack_blocks(generator, cfg, device, block_kind(cfg),
                                cfg.num_layers - n_attn),
        "final": {"norm": torch.ones((cfg.d_model,), dtype=dt,
                                     device=device)},
    }
    if n_attn:
        params[ATTN_BLOCKS] = _stack_blocks(generator, cfg, device, "moe",
                                            n_attn)
    if not cfg.tie_embeddings:
        params["final"]["head"] = init_dense(generator, cfg.d_model,
                                             cfg.vocab_size, dt, device)
    if cfg.is_encdec:
        params["enc_blocks"] = _stack_blocks(generator, cfg, device, "enc",
                                             cfg.encoder_layers)
    if cfg.is_encdec or (cfg.family == "vlm" and cfg.frontend_dim):
        params["enc_embed"] = {
            "proj": init_dense(generator, cfg.frontend_dim or cfg.d_model,
                               cfg.d_model, dt, device),
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
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None and not cfg.nope:
        if cfg.mrope:
            q = attn.apply_mrope(q, positions, cfg.mrope_sections,
                                 cfg.rope_theta)
            k = attn.apply_mrope(k, positions, cfg.mrope_sections,
                                 cfg.rope_theta)
        else:
            q = attn.apply_rope(q, positions, cfg.rope_theta)
            k = attn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attn(p, cfg: ModelConfig, x, positions, *, causal=True,
               flash_attention: Optional[Callable] = None):
    """Self-attention over positions ``arange(S)`` (the only positions the
    full-sequence passes use)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if cfg.attention_multiplier:
        q = q * (cfg.attention_multiplier * math.sqrt(cfg.hd))
    o = attn.attend(q, k, v, causal=causal, window=cfg.sliding_window,
                    chunk=cfg.attn_chunk, probs_bf16=cfg.attn_probs_bf16,
                    flash_attention=flash_attention)
    return lora_dense(o.reshape(b, s, -1), p["wo"], p.get("lora"), "wo")


def _cross_attn(p, cfg: ModelConfig, x, enc_kv,
                flash_attention: Optional[Callable] = None):
    """Cross-attention of ``x`` (B, S, D) to a precomputed encoder K/V
    pair, each (B, S_enc, KV, hd): every row sees every frame (non-causal,
    no window, whatever ``cfg.sliding_window`` says)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.hd)
    k, v = enc_kv
    # f32 K/V of f32 frames: attend in f32 and return q's dtype
    dt = torch.promote_types(q.dtype, k.dtype)
    o = attn.attend(q.to(dt), k, v, causal=False, window=0,
                    flash_attention=flash_attention).to(q.dtype)
    return o.reshape(b, s, -1) @ p["wo"]


# ======================================================================
# Block forward (full sequence)
# ======================================================================
def _ffn(blk, cfg: ModelConfig, h, kind: str):
    """The block's feed-forward on ``h = ln2(x)``: (out, aux), aux the
    experts' balance loss for the kinds with experts, None for an MLP."""
    if kind in ("moe", "ssm_moe"):
        return moe_mod.moe_fwd(blk["moe"], h, cfg)
    return mlp_fwd(blk["mlp"], h), None


def _residual(cfg: ModelConfig, x, branch):
    """``x + residual_multiplier · branch`` (no product at 1)."""
    r = cfg.residual_multiplier
    return x + (branch if r == 1.0 else r * branch)


def _block_fwd(blk, cfg: ModelConfig, x, positions, kind: str,
               flash_attention=None, enc_kv=None):
    """One block of ``kind``; ``enc_kv`` is a ``dec`` block's (k, v) pair
    (without it the block skips its cross-attention, as the reference)."""
    eps = cfg.norm_eps
    h = rms_norm(x, blk["ln1"], eps)
    if kind == "ssm":
        return (_residual(cfg, x, ssm_mod.ssd_fwd(blk["ssm"], h, cfg)),
                torch.zeros((), device=x.device))
    if kind == "ssm_moe":
        o = ssm_mod.ssd_fwd(blk["ssm"], h, cfg)
    else:
        o = _self_attn(blk["attn"], cfg, h, positions, causal=kind != "enc",
                       flash_attention=flash_attention)
    if kind == "hybrid":
        o = 0.5 * (o + ssm_mod.ssd_fwd(blk["ssm"], h, cfg))
    x = _residual(cfg, x, o)
    if kind == "dec" and enc_kv is not None:
        x = _residual(cfg, x, _cross_attn(
            blk["cross"], cfg, rms_norm(x, blk["ln_cross"], eps), enc_kv,
            flash_attention))
    out, aux = _ffn(blk, cfg, rms_norm(x, blk["ln2"], eps), kind)
    return (_residual(cfg, x, out),
            torch.zeros((), device=x.device) if aux is None else aux)


class _RecomputeBlock(torch.autograd.Function):
    """``apply(fn, *tensors) = fn(*tensors)`` (a block's ``(x, aux)``),
    keeping only ``tensors`` (the block's input and its weights, which stay
    alive anyway) for the backward, which recomputes ``fn`` under
    ``torch.func.vjp`` with respect to the inputs that need a gradient and
    takes both outputs' cotangents. ``generate_vmap_rule`` lets
    ``torch.func.vmap`` batch forward and backward as plain ops."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, dx, daux):
        # detached: the recompute is not itself recorded for a second
        # derivative (torch.func.grad runs its backward with
        # create_graph=True, which would otherwise keep every recomputed
        # block alive until the end of the backward pass)
        tensors = [t.detach() for t in ctx.saved_tensors]
        need = [i for i, n in enumerate(ctx.needs_input_grad[1:]) if n]

        def part(*diff):
            full = list(tensors)
            for i, t in zip(need, diff):
                full[i] = t
            return ctx.fn(*full)

        _, vjp = torch.func.vjp(part, *(tensors[i] for i in need))
        grads = [None] * len(tensors)
        for i, g in zip(need, vjp((dx.detach(), daux.detach()))):
            grads[i] = g
        return (None, *grads)


def _run_stack(layers, cfg: ModelConfig, x, positions, kind,
               enc_kv=None, flash_attention=None):
    """(x, aux): the blocks of ``layers`` (a stack's per-layer trees,
    :func:`tree_unbind`) in order, each of ``kind`` (one kind, or a list of
    one a layer), aux summed over the layers in f32. ``enc_kv``: the
    decoder's stacked (L, B, S_enc, KV, hd) pair; layer ``l`` reads its
    slice ``l``, unbound once too."""
    aux = torch.zeros((), device=x.device)
    kinds = [kind] * len(layers) if isinstance(kind, str) else kind
    kvs = ([()] * len(layers) if enc_kv is None
           else zip(*map(tree_unbind, enc_kv)))
    for blk, kind, kv in zip(layers, kinds, kvs):
        if not cfg.remat_blocks:
            x, a = _block_fwd(blk, cfg, x, positions, kind, flash_attention,
                              kv or None)
            aux = aux + a
            continue
        paths, leaves = zip(*leaf_paths(blk))

        def fn(x, positions, *tensors, paths=paths, n=len(kv), kind=kind):
            return _block_fwd(tree_from_paths(paths, tensors[n:]), cfg, x,
                              positions, kind, flash_attention,
                              tensors[:n] or None)

        # every tensor is an argument, the layer's K/V slices too: a
        # generated vmap rule refuses a closure over a tensor made inside
        # the transforms
        x, a = _RecomputeBlock.apply(fn, x, positions, *kv, *leaves)
        aux = aux + a
    return x, aux


def stack_layers(params, cfg: ModelConfig):
    """``(layers, kinds)``: the decoder stack's per-layer trees in order,
    each stacked key unbound once, and each layer's kind. A patterned
    stack interleaves ``params["attn_blocks"]`` and ``params["blocks"]``
    in the pattern's order."""
    kinds = layer_kinds(cfg)
    if not cfg.attn_period:
        return tree_unbind(params["blocks"]), kinds
    attn_layers = iter(tree_unbind(params[ATTN_BLOCKS])
                       if ATTN_BLOCKS in params else ())
    other = iter(tree_unbind(params["blocks"]))
    return [next(attn_layers) if k == "moe" else next(other)
            for k in kinds], kinds


# ======================================================================
# Full forward pass
# ======================================================================
def _positions_for(cfg: ModelConfig, batch: int, seq: int, device,
                   offset: int = 0):
    if cfg.mrope:
        return attn.text_mrope_positions(batch, seq, device) + offset
    return torch.arange(seq, device=device)[None, :].expand(batch, seq) \
        + offset


def _encode(params, cfg: ModelConfig, enc_inputs,
            flash_attention: Optional[Callable] = None):
    """Frontend stub frames (B, S_enc, F) -> encoder stack -> (B, S_enc,
    D) in the frames' and the compute dtype's promotion: frames wider than
    the compute dtype run the encoder in their dtype, its weights cast up;
    other frames are cast to the compute dtype."""
    compute = dtype_of(cfg.compute_dtype)
    dt = torch.promote_types(enc_inputs.dtype, compute)
    enc = {"enc_embed": params["enc_embed"],
           "enc_blocks": params["enc_blocks"]}
    if dt != compute:
        enc = tree_map(lambda l: l.to(dt) if l.is_floating_point() else l,
                       enc)
    x = enc_inputs.to(dt) @ enc["enc_embed"]["proj"]
    x = rms_norm(x, enc["enc_embed"]["norm"], cfg.norm_eps)
    pos = _positions_for(cfg, x.shape[0], x.shape[1], x.device)
    x, _ = _run_stack(tree_unbind(enc["enc_blocks"]), cfg, x, pos, "enc",
                      flash_attention=flash_attention)
    return x


def _cross_kv(cross, cfg: ModelConfig, enc_out):
    """One decoder layer's cross K/V from the encoder's output, each (B,
    S_enc, KV, hd)."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.num_kv_heads, cfg.hd)
    dt = torch.promote_types(enc_out.dtype, cross["wk"].dtype)
    return ((enc_out @ cross["wk"].to(dt)).reshape(shape),
            (enc_out @ cross["wv"].to(dt)).reshape(shape))


def _enc_kv_all(layers, cfg: ModelConfig, enc_out):
    """Every decoder layer's cross K/V, computed once: a stacked (L, B,
    S_enc, KV, hd) pair. ``layers``: the decoder's stack unbound, the
    views its blocks read too, so each cross leaf still takes one
    gradient write."""
    pairs = [_cross_kv(layer["cross"], cfg, enc_out) for layer in layers]
    return (torch.stack([k for k, _ in pairs]),
            torch.stack([v for _, v in pairs]))


def _embed_tokens(params, cfg: ModelConfig, tokens, embeddings=None):
    x = params["embed"]["tok"][tokens]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if embeddings is not None and cfg.family == "vlm":
        # VLM early-fusion stub: add projected patch embeddings to the first
        # S_vis token slots (precomputed by the stubbed vision tower).
        proj = embeddings @ params["enc_embed"]["proj"]
        proj = rms_norm(proj, params["enc_embed"]["norm"], cfg.norm_eps)
        x[:, :proj.shape[1], :] += proj.to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final"]["norm"], cfg.norm_eps)
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["final"]["head"])
    logits = x @ head.to(x.dtype)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _need_frames(cfg: ModelConfig, enc_inputs):
    if enc_inputs is None:
        raise ValueError(f"{cfg.name}: an enc-dec model needs enc_inputs")
    return enc_inputs


def forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
            enc_inputs: Optional[torch.Tensor] = None,
            embeddings: Optional[torch.Tensor] = None, *,
            flash_attention: Optional[Callable] = None):
    """Full-sequence forward. tokens: (B, S) int -> logits (B, S, V), aux
    (the experts' balance loss summed over the layers, f32; 0 for the kinds
    without experts). An enc-dec model needs ``enc_inputs``, (B, S_enc, F)
    frames; the other models ignore them.
    ``flash_attention`` replaces the kernel on CUDA (see
    :func:`repro_torch.models.attention.attend`)."""
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens, embeddings)
    pos = _positions_for(cfg, b, s, tokens.device)
    layers, kinds = stack_layers(params, cfg)
    enc_kv = None
    if cfg.is_encdec:
        enc_kv = _enc_kv_all(layers, cfg, _encode(
            params, cfg, _need_frames(cfg, enc_inputs), flash_attention))
    x, aux = _run_stack(layers, cfg, x, pos, kinds, enc_kv, flash_attention)
    return _logits(params, cfg, x), aux


# ======================================================================
# Loss
# ======================================================================
def lm_loss(params: Pytree, cfg: ModelConfig, batch: dict, *,
            flash_attention: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy (+ 0.01 · aux). batch: tokens, labels[,
    enc_inputs, embeddings]; log-softmax in f32, labels < 0 masked out."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          enc_inputs=batch.get("enc_inputs"),
                          embeddings=batch.get("embeddings"),
                          flash_attention=flash_attention)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    nll = -torch.take_along_dim(
        logp, torch.where(mask, labels, 0).long()[..., None], dim=-1)[..., 0]
    mask = mask.float()
    loss = torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
    return loss + 0.01 * aux


def make_lm_loss(cfg: ModelConfig, *,
                 flash_attention: Optional[Callable] = None):
    """A ``loss_fn(params, batch)`` closure over ``cfg`` for the FL
    drivers."""
    def loss_fn(params: Pytree, batch: dict) -> torch.Tensor:
        return lm_loss(params, cfg, batch, flash_attention=flash_attention)

    return loss_fn
