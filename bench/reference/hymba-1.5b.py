"""Plain Hymba-style hybrid LM in f32, for the check.

Each of the L blocks runs grouped-query causal attention and a Mamba-2 SSD
mixer side by side on the same normalised input and averages them, then a
SwiGLU MLP::

    h = rms(x) · ln1;  x = x + (attn(h) + ssd(h)) / 2
    x = x + mlp(rms(x) · ln2)

with rms(x) = x / sqrt(mean(x²) + 1e-6). Attention: q, k, v projections,
rotary embedding on the two halves of each head (base ``rope_theta``),
query head h reading key/value head h // (H / KV), softmax(q·kᵀ/√hd) over
the positions up to its own, the output projection. SSD (arXiv:2405.21060)
with one B/C group: in_proj to (z, x, B, C, dt), a depthwise causal
convolution of width W over (x, B, C) with SiLU, dt = softplus(dt + bias),
A = −exp(A_log); per chunk of Q positions the dual form y_i = Σ_{j≤i}
(C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j, a recurrence of the (H, N, P) state
across chunks, the skip D·x, a gated RMS norm by SiLU(z), out_proj. Then
the final norm, the head, and the mean next-token negative log-likelihood
over labels ≥ 0. The program's documented departures from the published
model (no meta tokens, full attention in every block) are this model's
too. Imports torch and ``bench.reference`` only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference import plain


def _dims(m: dict) -> dict:
    di = m["ssm_expand"] * m["d_model"]
    return {"d": m["d_model"], "L": m["num_layers"], "H": m["num_heads"],
            "KV": m["num_kv_heads"], "hd": m["head_dim"], "F": m["d_ff"],
            "V": m["vocab_size"], "N": m["ssm_state"], "P": m["ssm_head_dim"],
            "di": di, "nh": di // m["ssm_head_dim"],
            "W": m["ssm_conv_width"], "Q": m["ssm_chunk"]}


def param_spec(model: dict) -> list:
    z = _dims(model)
    d, L, hd = z["d"], z["L"], z["hd"]
    qdim, kvdim = z["H"] * hd, z["KV"] * hd
    conv = z["di"] + 2 * z["N"]

    def dense(path, din, dout, lead=(L,)):
        return (path, (*lead, din, dout), ("normal", 1.0 / math.sqrt(din)))

    return [
        (("embed", "tok"), (z["V"], d), ("normal", 0.02)),
        (("blocks", "ln1"), (L, d), ("const", 1.0)),
        dense(("blocks", "attn", "wq"), d, qdim),
        dense(("blocks", "attn", "wk"), d, kvdim),
        dense(("blocks", "attn", "wv"), d, kvdim),
        dense(("blocks", "attn", "wo"), qdim, d),
        dense(("blocks", "ssm", "in_proj"), d,
              2 * z["di"] + 2 * z["N"] + z["nh"]),
        (("blocks", "ssm", "conv_w"), (L, z["W"], conv), ("normal", 0.1)),
        (("blocks", "ssm", "conv_b"), (L, conv), ("const", 0.0)),
        (("blocks", "ssm", "A_log"), (L, z["nh"]), ("const", 0.0)),
        (("blocks", "ssm", "D_skip"), (L, z["nh"]), ("const", 1.0)),
        (("blocks", "ssm", "dt_bias"), (L, z["nh"]), ("const", -2.0)),
        (("blocks", "ssm", "norm_scale"), (L, z["di"]), ("const", 1.0)),
        dense(("blocks", "ssm", "out_proj"), z["di"], d),
        (("blocks", "ln2"), (L, d), ("const", 1.0)),
        dense(("blocks", "mlp", "w_gate"), d, z["F"]),
        dense(("blocks", "mlp", "w_up"), d, z["F"]),
        dense(("blocks", "mlp", "w_down"), z["F"], d),
        (("final", "norm"), (d,), ("const", 1.0)),
        dense(("final", "head"), d, z["V"], lead=()),
    ]


def _rms(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def _rope(x, theta: float):
    """x: (B, S, heads, hd); rotate the halves by position·theta^(-i/half)."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(p, h, z, theta: float, prec: str):
    b, s, _ = h.shape
    hd, kvh = z["hd"], z["KV"]
    g = z["H"] // kvh
    q = _rope(plain.mm(h, p["wq"], prec).view(b, s, z["H"], hd), theta)
    k = _rope(plain.mm(h, p["wk"], prec).view(b, s, kvh, hd), theta)
    v = plain.mm(h, p["wv"], prec).view(b, s, kvh, hd)
    q = q.view(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)      # B KV G S hd
    k = k.permute(0, 2, 1, 3)[:, :, None]                    # B KV 1 S hd
    v = v.permute(0, 2, 1, 3)[:, :, None]
    scores = plain.mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
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
    y = _rms(y * F.silu(zg), p["norm_scale"])
    return plain.mm(y, p["out_proj"], prec)


def _mlp(p, h, prec: str):
    return plain.mm(F.silu(plain.mm(h, p["w_gate"], prec))
                    * plain.mm(h, p["w_up"], prec), p["w_down"], prec)


def loss(params: dict, model: dict, batch: dict,
         prec: str = "f32") -> torch.Tensor:
    z = _dims(model)
    theta = float(model["rope_theta"])
    x = params["embed"]["tok"][batch["tokens"]]
    blocks = params["blocks"]
    for layer in range(z["L"]):
        blk = {k: ({kk: vv[layer] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[layer])
               for k, v in blocks.items()}
        h = _rms(x, blk["ln1"])
        x = x + 0.5 * (_attention(blk["attn"], h, z, theta, prec)
                       + _ssd(blk["ssm"], h, z, prec))
        x = x + _mlp(blk["mlp"], _rms(x, blk["ln2"]), prec)
    logits = plain.mm(_rms(x, params["final"]["norm"]),
                      params["final"]["head"], prec)
    labels = batch["labels"]
    keep = labels >= 0
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, torch.where(keep, labels, 0).long()[..., None])
    return (nll[..., 0] * keep).sum() / keep.sum().clamp_min(1)
