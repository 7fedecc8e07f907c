"""Shared neural-net building blocks, port of ``repro.models.layers``
(functional: parameters are plain tensors in nested dicts).

The reference's cast points are kept: :func:`rms_norm` works in f32 with
eps 1e-6 (the models pass ``ModelConfig.norm_eps``) and casts back to the
input's dtype; the SwiGLU gate's SiLU works in f32 and is cast to the
activation dtype before the product with ``u``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, dtype_of


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _normal(generator: torch.Generator, shape, std: float, dtype, device):
    """N(0, std²) drawn on the generator's device, then moved and cast. On
    the ``meta`` device nothing is drawn (and ``generator`` may be None):
    the result has the shape and dtype only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(device=device, dtype=dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float | None = None, lead: tuple = ()):
    """(*lead, d_in, d_out) weights with std ``1/sqrt(d_in)`` (or
    ``scale``); ``lead`` stacks layers."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(generator, (*lead, d_in, d_out), s, dtype, device)


def init_embed(generator: torch.Generator, vocab: int, d: int, dtype,
               device):
    return _normal(generator, (vocab, d), 0.02, dtype, device)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP used by the Qwen/Llama/DeepSeek family."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def lora_dense(x, w, lora=None, name=None):
    """Dense projection with an optional LoRA adapter delta:
    ``x @ w`` plus ``(x @ a) @ b`` when ``lora`` holds factors for
    ``name`` (factors cast to the activation dtype)."""
    y = x @ w
    if lora is not None and name in lora:
        f = lora[name]
        y = y + (x @ f["a"].to(x.dtype)) @ f["b"].to(x.dtype)
    return y


def init_mlp(generator: torch.Generator, cfg: ModelConfig, device,
             d_ff: int | None = None, lead: tuple = ()):
    dt = dtype_of(cfg.param_dtype)
    f = d_ff or cfg.d_ff
    return {
        "w_gate": init_dense(generator, cfg.d_model, f, dt, device, lead=lead),
        "w_up": init_dense(generator, cfg.d_model, f, dt, device, lead=lead),
        "w_down": init_dense(generator, f, cfg.d_model, dt, device,
                             lead=lead),
    }


def mlp_fwd(p, x):
    lora = p.get("lora")
    if lora is None:
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    g = lora_dense(x, p["w_gate"], lora, "w_gate")
    u = lora_dense(x, p["w_up"], lora, "w_up")
    h = F.silu(g.float()).to(x.dtype) * u
    return lora_dense(h, p["w_down"], lora, "w_down")
