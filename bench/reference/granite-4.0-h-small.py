"""Plain granite-4.0-h LM in f32, for the check: one chip's share of a
layer's experts and of the vocabulary.

The L layers follow a pattern: layer i attends where ``i % attn_period ==
attn_offset`` and runs a Mamba-2 SSD mixer otherwise; the attention
layers' leaves are stacked under ``attn_blocks``, the Mamba layers' under
``blocks``, each in layer order. With r the residual multiplier and
rms(x) = x / sqrt(mean(x²) + eps), every layer is::

    x = x + r · mixer(rms(x) · ln1)
    h = rms(x) · ln2;  x = x + r · (experts(h) + shared(h))

Embedding: the table's rows times ``embedding_multiplier``. Attention: q,
k, v projections without bias and without a positional embedding (NoPE),
query head h reading key/value head h // (H / KV), softmax(q·kᵀ ·
attention_multiplier) over the positions up to its own, the output
projection. SSD (arXiv:2405.21060) with one B/C group: in_proj to (z, x, B,
C, dt), a depthwise causal convolution of width W with bias over (x, B, C)
and SiLU, dt = softplus(dt + bias), A = −exp(A_log); per chunk of Q
positions the dual form
y_i = Σ_{j≤i} (C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j, a recurrence of the
(H, N, P) state across chunks, the skip D·x, a gated RMS norm
rms(y·SiLU(z)) over d_inner, out_proj. Experts: the router's
logits over all R experts, the top k of them (ties to the lower index),
the gates their softmax; the E experts held here are experts
``expert_offset`` … ``expert_offset + E − 1``, and each computes its SwiGLU
over the rows routed to it, times their gates, added to those rows; a
choice of an absent expert adds nothing. The shared expert is a SwiGLU of
width ``shared_d_ff`` over every row. Then the final norm, the tied head
(the table transposed), the logits divided by ``logits_scaling``, and the
mean next-token negative log-likelihood over labels ≥ 0, plus 0.01 × the
layers' summed balance loss R · Σ_e mean_t(softmax(logits)_e) · (share of
the T·k choices that chose e), as the program's other MoE models. Imports
torch and ``bench.reference`` only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import plain

AUX_WEIGHT = 0.01


def _dims(m: dict) -> dict:
    di = m["ssm_expand"] * m["d_model"]
    return {"d": m["d_model"], "L": m["num_layers"], "H": m["num_heads"],
            "KV": m["num_kv_heads"], "hd": m["head_dim"],
            "V": m["vocab_size"], "N": m["ssm_state"], "P": m["ssm_head_dim"],
            "di": di, "nh": di // m["ssm_head_dim"],
            "W": m["ssm_conv_width"], "Q": m["ssm_chunk"],
            "E": m["num_experts"], "R": m["router_experts"],
            "k": m["moe_top_k"], "f": m["moe_d_ff"], "fs": m["shared_d_ff"],
            "eps": m["norm_eps"]}


def attention_layers(model: dict) -> list[bool]:
    """Whether each layer, in order, attends."""
    return [i % model["attn_period"] == model["attn_offset"]
            for i in range(model["num_layers"])]


def param_spec(model: dict) -> list:
    z = _dims(model)
    kinds = attention_layers(model)
    n_attn = sum(kinds)
    d, hd, e = z["d"], z["hd"], z["E"]
    conv = z["di"] + 2 * z["N"]

    def dense(path, din, dout, lead):
        return (path, (*lead, din, dout), ("normal", 1.0 / math.sqrt(din)))

    def ffn(key, depth):
        lead = (depth,)
        return [
            (key + ("ln2",), (depth, d), ("const", 1.0)),
            dense(key + ("moe", "router"), d, z["R"], lead),
            dense(key + ("moe", "w_gate"), d, z["f"], (depth, e)),
            dense(key + ("moe", "w_up"), d, z["f"], (depth, e)),
            dense(key + ("moe", "w_down"), z["f"], d, (depth, e)),
            dense(key + ("moe", "shared", "w_gate"), d, z["fs"], lead),
            dense(key + ("moe", "shared", "w_up"), d, z["fs"], lead),
            dense(key + ("moe", "shared", "w_down"), z["fs"], d, lead),
        ]

    spec = [(("embed", "tok"), (z["V"], d), ("normal", 0.02))]
    if n_attn:
        a, lead = ("attn_blocks",), (n_attn,)
        spec += [
            (a + ("ln1",), (n_attn, d), ("const", 1.0)),
            dense(a + ("attn", "wq"), d, z["H"] * hd, lead),
            dense(a + ("attn", "wk"), d, z["KV"] * hd, lead),
            dense(a + ("attn", "wv"), d, z["KV"] * hd, lead),
            dense(a + ("attn", "wo"), z["H"] * hd, d, lead),
        ] + ffn(a, n_attn)
    n_ssm = len(kinds) - n_attn
    if n_ssm:
        m, lead = ("blocks",), (n_ssm,)
        spec += [
            (m + ("ln1",), (n_ssm, d), ("const", 1.0)),
            dense(m + ("ssm", "in_proj"), d,
                  2 * z["di"] + 2 * z["N"] + z["nh"], lead),
            (m + ("ssm", "conv_w"), (n_ssm, z["W"], conv), ("normal", 0.1)),
            (m + ("ssm", "conv_b"), (n_ssm, conv), ("const", 0.0)),
            (m + ("ssm", "A_log"), (n_ssm, z["nh"]), ("const", 0.0)),
            (m + ("ssm", "D_skip"), (n_ssm, z["nh"]), ("const", 1.0)),
            (m + ("ssm", "dt_bias"), (n_ssm, z["nh"]), ("const", -2.0)),
            (m + ("ssm", "norm_scale"), (n_ssm, z["di"]), ("const", 1.0)),
            dense(m + ("ssm", "out_proj"), z["di"], d, lead),
        ] + ffn(m, n_ssm)
    spec.append((("final", "norm"), (d,), ("const", 1.0)))
    return spec


def _rms(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _attention(p, h, z, scale: float, prec: str):
    b, s, _ = h.shape
    hd, kvh = z["hd"], z["KV"]
    g = z["H"] // kvh
    q = plain.mm(h, p["wq"], prec).view(b, s, kvh, g, hd)
    k = plain.mm(h, p["wk"], prec).view(b, s, kvh, hd)
    v = plain.mm(h, p["wv"], prec).view(b, s, kvh, hd)
    q = q.permute(0, 2, 3, 1, 4)                             # B KV G S hd
    k = k.permute(0, 2, 1, 3)[:, :, None]                    # B KV 1 S hd
    v = v.permute(0, 2, 1, 3)[:, :, None]
    scores = plain.mm(q, k.transpose(-1, -2), prec) * scale
    future = torch.ones((s, s), dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    o = plain.mm(probs, v, prec)                             # B KV G S hd
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, z["H"] * hd)
    return plain.mm(o, p["wo"], prec)


def _ssd(p, h, z, prec: str):
    b, s, _ = h.shape
    di, n, nh, pd, q, w = z["di"], z["N"], z["nh"], z["P"], z["Q"], z["W"]
    zg, xbc, dt = torch.split(plain.mm(h, p["in_proj"], prec),
                              [di, di + 2 * n, nh], -1)
    xp = F.pad(xbc, (0, 0, w - 1, 0))
    xbc = F.silu(sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(w))
                 + p["conv_b"])
    x, bm, cm = torch.split(xbc, [di, n, n], -1)
    nc = -(-s // q)
    pad = nc * q - s
    dt = F.softplus(dt + p["dt_bias"])
    if pad:
        x, bm, cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, bm, cm, dt))
    xh = x.reshape(b, nc, q, nh, pd).transpose(2, 3)         # B NC H Q P
    bc = bm.reshape(b, nc, q, n)
    cc = cm.reshape(b, nc, q, n)
    dt = dt.reshape(b, nc, q, nh).transpose(2, 3)            # B NC H Q
    cum = torch.cumsum(dt * -torch.exp(p["A_log"])[:, None], -1)
    cb = plain.mm(cc, bc.transpose(-1, -2), prec)            # B NC Q Q
    later = torch.ones((q, q), dtype=torch.bool, device=h.device).triu(1)
    decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(later, float("-inf")))
    y = plain.mm(cb[:, :, None] * decay * dt[..., None, :], xh, prec)
    to_end = torch.exp(cum[..., -1:] - cum)
    chunk_state = plain.mm(bc.transpose(-1, -2)[:, :, None],
                           (to_end * dt)[..., None] * xh, prec)  # B NC H N P
    state = torch.zeros((b, nh, n, pd), dtype=torch.float32,
                        device=h.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = torch.exp(cum[:, c, :, -1])[..., None, None] * state \
            + chunk_state[:, c]
    y = y + plain.mm(cc[:, :, None], torch.stack(before, 1), prec) \
        * torch.exp(cum)[..., None]
    y = y + p["D_skip"][:, None, None] * xh
    y = y.transpose(2, 3).reshape(b, nc * q, di)[:, :s]
    y = _rms(y * F.silu(zg), p["norm_scale"], z["eps"])
    return plain.mm(y, p["out_proj"], prec)


def _swiglu(x, w_gate, w_up, w_down, prec: str):
    return plain.mm(F.silu(plain.mm(x, w_gate, prec))
                    * plain.mm(x, w_up, prec), w_down, prec)


def experts(p, h, z, offset: int, prec: str):
    """The held experts' part of the layer for (B, S, D) ``h``, without
    the shared expert: ``(out (B, S, D), balance loss)``. Each held expert
    runs over the rows routed to it, found on the host."""
    b, s, d = h.shape
    t, k, r = b * s, z["k"], z["R"]
    xt = h.reshape(t, d)
    logits = plain.mm(xt, p["router"], prec)                 # (T, R)
    top, choice = torch.sort(logits, dim=-1, descending=True,
                             stable=True)
    gates = torch.softmax(top[:, :k], -1)                    # (T, k)
    choice = choice[:, :k]
    out = torch.zeros_like(xt)
    for e in range(p["w_gate"].shape[0]):
        rows, slot = (choice == offset + e).nonzero(as_tuple=True)
        if rows.numel():
            y = _swiglu(xt[rows], p["w_gate"][e], p["w_up"][e],
                        p["w_down"][e], prec)
            out = out.index_add(0, rows, y * gates[rows, slot][:, None])
    share = torch.bincount(choice.reshape(-1), minlength=r).float() / (t * k)
    aux = r * torch.sum(torch.softmax(logits, -1).mean(0) * share)
    return out.reshape(b, s, d), aux


def _pick(tree, j: int):
    """Layer ``j`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, j) for k, v in tree.items()}
    return tree[j]


def _layer(blk: dict, attends: bool, x, z, model: dict, prec: str):
    """One layer: ``(x, balance loss)``."""
    r, eps = model["residual_multiplier"], z["eps"]
    if attends:
        mixed = _attention(blk["attn"], _rms(x, blk["ln1"], eps), z,
                           model["attention_multiplier"], prec)
    else:
        mixed = _ssd(blk["ssm"], _rms(x, blk["ln1"], eps), z, prec)
    x = x + r * mixed
    h = _rms(x, blk["ln2"], eps)
    routed, aux = experts(blk["moe"], h, z, model.get("expert_offset", 0),
                          prec)
    sh = blk["moe"]["shared"]
    x = x + r * (routed + _swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"],
                                  prec))
    return x, aux


def loss(params: dict, model: dict, batch: dict,
         prec: str = "f32") -> torch.Tensor:
    """Each layer is recomputed in the backward
    (``torch.utils.checkpoint``), which changes no number and keeps the
    check's peak, and the caching allocator's fragments, down at full
    width."""
    z = _dims(model)
    x = params["embed"]["tok"][batch["tokens"]] * model["embedding_multiplier"]
    aux = torch.zeros((), device=x.device)
    seen = {True: 0, False: 0}
    for attends in attention_layers(model):
        key = "attn_blocks" if attends else "blocks"
        blk = _pick(params[key], seen[attends])
        seen[attends] += 1
        x, a = checkpoint(_layer, blk, attends, x, z, model, prec,
                          use_reentrant=False)
        aux = aux + a
    logits = plain.mm(_rms(x, params["final"]["norm"], z["eps"]),
                      params["embed"]["tok"].T, prec) / model["logits_scaling"]
    labels = batch["labels"]
    keep = labels >= 0
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, torch.where(keep, labels, 0).long()[..., None])
    return (nll[..., 0] * keep).sum() / keep.sum().clamp_min(1) \
        + AUX_WEIGHT * aux
