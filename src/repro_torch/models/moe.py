"""Mixture-of-Experts layer (llama4-style top-1 and deepseek-style
shared + routed top-k), port of ``repro.models.moe`` (plain PyTorch ops:
the reference computes the expert products as ``einsum`` s outside any
Pallas kernel).

Dispatch is capacity-based, as in the reference: each (token, choice)
gets a position in its expert's buffer from an exclusive cumulative sum
over the routing one-hot in (token, choice) order (held as (E, T·k));
choices at or past the capacity are dropped (their gate set to 0). The tokens are scattered into
an (E, C, D) buffer, the experts run as batched SwiGLU products over E,
and the outputs are gathered back and combined with the gates. So every
expert runs ``C`` rows whatever the routing, and every shape is static: no
host sync and no data-dependent shape, which ``torch.func.vmap`` (the
federated fine-tuning path) and the card's asynchronous stream need.

Where the port differs from the reference, the values do not:

- ``jax.lax.top_k`` breaks ties toward the lower index, ``torch.topk``
  promises no order among ties: the top k are the first k of a stable
  descending sort.
- ``jax.nn.one_hot`` becomes a comparison with ``arange(E)``
  (``F.one_hot`` reads its input's maximum on the host and is refused
  under ``vmap``).
- ``.at[].set(mode="drop")`` sends a dropped choice out of bounds; here the
  buffer has one more slot an expert, ``(E, C + 1, D)``, the dropped
  choices all land in that trash slot (an out-of-place ``index_put``) and
  the buffer is sliced to ``[:, :C]``.

The capacity counts every token of the call (``T = B·S``), so ``forward``
over S + t tokens, ``prefill`` over S and a decode step over B tokens can
drop different choices, as the reference does.

``ModelConfig.moe_dropless`` (granite-4.0-h) takes the other path,
:func:`moe_share_fwd`: the layer holds ``num_experts`` of the router's
``router_width`` experts, from ``expert_offset`` on (one chip's share under
expert parallelism; all of them where the two are equal), routes over all
of them, and computes its own experts' part of the result. A choice of an
absent expert adds nothing. No choice drops: each held expert's buffer is
the call's T tokens in order, row t token t, weighted by t's gate where t
chose the expert and by 0 where it did not (a token chooses an expert at
most once, so T rows hold every choice). Every held expert so runs T rows,
of which T·k/router_width are routed to it on average; the shapes stay
static, with no host sync. Its work is enqueued under the spans
``moe.fwd`` > ``moe.route``, ``moe.experts`` (the three products and
SiLU), ``moe.combine``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.layers import _normal, init_dense, init_mlp, mlp_fwd
from repro_torch.telemetry.profiling import span


def init_moe(generator: torch.Generator, cfg: ModelConfig, device,
             lead: tuple = ()):
    """The reference's leaves (the router (d, router_width) in f32, the
    held expert banks ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f,
    d) with std ``1/sqrt(d_in)``, the shared experts an MLP of width
    ``shared_width``), each with the leading ``lead`` axes (the stacked
    layers).

    An expert bank is drawn one layer at a time into a tensor of the param
    dtype, so the f32 transient is one layer's, not the whole stack's."""
    dt = dtype_of(cfg.param_dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": init_dense(generator, d, cfg.router_width, torch.float32,
                              device, lead=lead)}
    for name, (d_in, d_out) in (("w_gate", (d, f)), ("w_up", (d, f)),
                                ("w_down", (f, d))):
        bank = torch.empty((*lead, e, d_in, d_out), dtype=dt, device=device)
        for l in range(math.prod(lead)):
            bank.view(-1, e, d_in, d_out)[l] = _normal(
                generator, (e, d_in, d_out), 1.0 / math.sqrt(d_in), dt,
                device)
        p[name] = bank
    if cfg.shared_width > 0:
        p["shared"] = init_mlp(generator, cfg, device, d_ff=cfg.shared_width,
                               lead=lead)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.moe_top_k)


def route(p, xt: torch.Tensor, cfg: ModelConfig, cap: int):
    """Routing of (T, D) tokens: the f32 softmax ``probs`` (T, E), the
    chosen experts ``eidx`` (T, k), each choice's position ``pos`` (T, k)
    in its expert's buffer (``pos >= cap``: dropped) and the renormalised
    gates (T, k), 0 where dropped."""
    e, k = cfg.num_experts, cfg.moe_top_k
    t = xt.shape[0]
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (T, E)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :k], eidx[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # the one-hot held as (E, T*k), so the cumulative sum runs along the
    # contiguous axis: over (T*k, E) it is an outer-dim scan of only E
    # columns, about 100x slower on the card (chip_smoke.py phase 15 times
    # both at deepseek-moe-16b's prefill)
    onehot = (eidx.reshape(1, t * k) == torch.arange(
        e, device=xt.device)[:, None]).to(torch.int32)           # (E, T*k)
    pos = ((torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot)
           * onehot).sum(0).reshape(t, k)
    return probs, eidx, pos, gates * (pos < cap)


def moe_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (out (B, S, D), aux), aux the Switch-style
    load-balance loss in f32."""
    if cfg.moe_dropless:
        return moe_share_fwd(p, x, cfg)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.moe_top_k
    cap = _capacity(t, cfg)
    xt = x.reshape(t, d)
    probs, eidx, pos, gates = route(p, xt, cfg, cap)

    # scatter the (token, choice) rows into (E, C + 1, D); the dropped
    # ones all into the trash slot C
    eflat = eidx.reshape(-1)
    pflat = torch.clamp_max(pos.reshape(-1), cap)
    src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device) \
        .index_put((eflat, pflat), src)[:, :cap]

    # the experts' SwiGLU, batched over E
    g = buf @ p["w_gate"]
    u = buf @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    out_buf = h @ p["w_down"]                                    # (E, C, D)

    # gather back and combine with the gates
    gathered = out_buf[eflat, torch.clamp_max(pflat, cap - 1)]   # (T*k, D)
    out = (gathered.reshape(t, k, d)
           * gates[..., None].to(x.dtype)).sum(dim=1)
    if cfg.num_shared_experts > 0:
        out = out + mlp_fwd(p["shared"], xt)

    # every choice counts, dropped ones too
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add(
        0, eflat, torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                             device=x.device))
    aux = e * torch.sum(probs.mean(dim=0) * ce)
    return out.reshape(b, s, d), aux


def share_weights(p, xt: torch.Tensor, cfg: ModelConfig):
    """Routing of (T, D) tokens over the router's full width R, as
    granite-4.0-h routes: the top k logits (ties to the lower index), the
    gates their f32 softmax. Returns the (T, E) f32 weight of each held
    expert for each token (its gate where the token chose it, else 0) and
    the balance loss over all R experts, every choice counted."""
    r, k, e = cfg.router_width, cfg.moe_top_k, cfg.num_experts
    t = xt.shape[0]
    logits = xt.float() @ p["router"]                            # (T, R)
    top, eidx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :k], dim=-1)                    # (T, k)
    eidx = eidx[:, :k]
    held = torch.arange(cfg.expert_offset, cfg.expert_offset + e,
                        device=xt.device)
    weight = ((eidx[:, :, None] == held).to(gates.dtype)
              * gates[..., None]).sum(1)                         # (T, E)
    ce = torch.zeros((r,), dtype=torch.float32, device=xt.device).index_add(
        0, eidx.reshape(-1), torch.full((t * k,), 1.0 / (t * k),
                                        dtype=torch.float32,
                                        device=xt.device))
    probs = torch.softmax(logits, dim=-1)
    aux = r * torch.sum(probs.mean(dim=0) * ce)
    return weight, aux


def moe_share_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    """The held experts' part of a dropless layer, plus the shared expert
    (see the module doc). x: (B, S, D) -> (out (B, S, D), aux)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    with span("moe.fwd"):
        with span("moe.route"):
            weight, aux = share_weights(p, xt, cfg)
        with span("moe.experts"):
            g = xt @ p["w_gate"]                                 # (E, T, f)
            u = xt @ p["w_up"]
            h = F.silu(g.float()).to(x.dtype) * u
            y = h @ p["w_down"]                                  # (E, T, D)
        with span("moe.combine"):
            out = torch.einsum("te,etd->td", weight.to(x.dtype), y)
        if cfg.shared_width > 0:
            out = out + mlp_fwd(p["shared"], xt)
    return out.reshape(b, s, d), aux
