"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060], port of
``repro.models.ssm`` (plain PyTorch ops: the reference has no Pallas kernel
here).

Chunked SSD: within a chunk of length Q the recurrence is computed in its
quadratic "attention-like" dual form; across chunks a linear recurrence
carries the (H, N, P) state. Decode is the O(1) recurrent update
(:func:`ssd_step`), which is also the plain reference the chunked form is
held to.

Layout: one B/C group; heads H = expand·d_model / head_dim P; state size N
per head. Leaves, shapes, dtypes and constants are the reference's.

Where the port differs from the reference, the values do not:

- The reference's einsums are written as explicit products and batched
  ``matmul`` s over (B, NC, H, ...) (``torch.einsum``'s contraction order
  depends on whether ``opt_einsum`` is installed; these do not).
- The intra-chunk decay masks its exponent with ``-inf`` before the
  ``exp`` (the reference exponentiates every (i, j) and masks the result):
  the same values, but for j > i the exponent is positive and can
  overflow, and the gradient through a ``where`` over an ``inf`` is
  ``0·inf = NaN``.
- ``F.softplus`` returns x itself above 20, ``jax.nn.softplus`` does not;
  the difference there is below f32 rounding.
- The inter-chunk recurrence is a Python loop over chunks whose states are
  stacked (no in-place writes), so ``torch.func.vmap`` and ``grad`` work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, dtype_of
from repro_torch.models.layers import _normal, init_dense, lora_dense, rms_norm
from repro_torch.telemetry.profiling import span


def init_ssm(generator: torch.Generator, cfg: ModelConfig, device,
             lead: tuple = ()):
    """One SSD mixer's leaves, each with the leading ``lead`` axes (the
    stacked layers)."""
    dt = dtype_of(cfg.param_dtype)
    d, di, n, h, w = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv_width)
    conv_ch = di + 2 * n

    def full(size, value, dtype):
        return torch.full((*lead, size), value, dtype=dtype, device=device)

    return {
        "in_proj": init_dense(generator, d, 2 * di + 2 * n + h, dt, device,
                              lead=lead),
        "conv_w": _normal(generator, (*lead, w, conv_ch), 0.1, dt, device),
        "conv_b": full(conv_ch, 0.0, dt),
        "A_log": full(h, 0.0, torch.float32),        # A = -exp(A_log) = -1
        "D_skip": full(h, 1.0, torch.float32),
        "dt_bias": full(h, -2.0, torch.float32),     # softplus ~0.12
        "norm_scale": full(di, 1.0, dt),
        "out_proj": init_dense(generator, di, d, dt, device, lead=lead),
    }


def _split_proj(p, x, cfg: ModelConfig):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    zxbcdt = lora_dense(x, p["in_proj"], p.get("lora"), "in_proj")
    return torch.split(zxbcdt, [di, di + 2 * n, cfg.ssm_heads], dim=-1)


def _causal_conv(p, xbc, cfg: ModelConfig):
    """Depthwise causal conv over (B, S, C') channels, left-padded by W - 1:
    the W shifted multiply-adds, summed in f32 and rounded once to the
    activation dtype (as a convolution kernel accumulates); then the bias,
    and SiLU in f32, cast back."""
    w, s = cfg.ssm_conv_width, xbc.shape[1]
    kernel = p["conv_w"].to(xbc.dtype).float()                   # (W, C')
    xp = F.pad(xbc, (0, 0, w - 1, 0)).float()
    out = sum(xp[:, i:i + s] * kernel[i] for i in range(w)).to(xbc.dtype)
    return F.silu((out + p["conv_b"]).float()).to(xbc.dtype)


def _conv_tail(xbc_raw, w: int):
    """The last W - 1 raw (pre-conv) positions, left-padded with zeros when
    the sequence is shorter."""
    s = xbc_raw.shape[1]
    if s < w - 1:
        return F.pad(xbc_raw, (0, 0, w - 1 - s, 0))
    return xbc_raw[:, s - (w - 1):]


def ssd_fwd(p, xin: torch.Tensor, cfg: ModelConfig,
            return_cache: bool = False):
    """Full-sequence chunked SSD. xin: (B, S, D) -> (B, S, D)[, cache]; the
    cache is ``{"conv": (B, W-1, di+2n) raw tail, "state": (B, H, N, P)
    f32}``. Enqueued inside the span ``ssd.fwd``."""
    with span("ssd.fwd"):
        return _ssd_fwd(p, xin, cfg, return_cache)


def _ssd_fwd(p, xin: torch.Tensor, cfg: ModelConfig, return_cache: bool):
    bsz, s, _ = xin.shape
    di, n, h, pdim, q = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_head_dim, cfg.ssm_chunk)
    nc = -(-s // q)
    pad = nc * q - s

    z, xbc_raw, dt_raw = _split_proj(p, xin, cfg)
    xbc = _causal_conv(p, xbc_raw, cfg)
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    if pad:
        x, bmat, cmat, dt_raw = (F.pad(t, (0, 0, 0, pad))
                                 for t in (x, bmat, cmat, dt_raw))

    # heads first: (B, NC, H, Q, P), (B, NC, Q, N), (B, NC, H, Q)
    xh = x.reshape(bsz, nc, q, h, pdim).float().transpose(2, 3)
    bc = bmat.reshape(bsz, nc, q, n).float()
    cc = cmat.reshape(bsz, nc, q, n).float()
    dt = F.softplus(dt_raw.reshape(bsz, nc, q, h).float() + p["dt_bias"])
    if pad:
        # padded positions must not decay the state: dt -> 0 there
        valid = torch.arange(nc * q, device=xin.device) < s
        dt = dt * valid.reshape(1, nc, q, 1)
    dt = dt.transpose(2, 3)                                      # (B,NC,H,Q)
    a = -torch.exp(p["A_log"])                                   # (H,)
    cum = torch.cumsum(dt * a[:, None], dim=-1)                  # (B,NC,H,Q)

    # intra-chunk (dual quadratic form):
    # y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
    cb = cc @ bc.transpose(-1, -2)                               # (B,NC,Q,Q)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=xin.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]                  # (B,NC,H,Q,Q)
    decay = torch.exp(seg.masked_fill(~causal, -torch.inf))
    y = (cb[:, :, None] * decay * dt[..., None, :]) @ xh         # (B,NC,H,Q,P)

    # chunk summaries -> inter-chunk recurrence
    decay_end = torch.exp(cum[..., -1:] - cum)                   # (B,NC,H,Q)
    s_chunk = bc.transpose(-1, -2)[:, :, None] @ (
        (decay_end * dt)[..., None] * xh)                        # (B,NC,H,N,P)
    chunk_decay = torch.exp(cum[..., -1])                        # (B,NC,H)
    state = torch.zeros((bsz, h, n, pdim), dtype=torch.float32,
                        device=xin.device)
    states = []                                  # the state BEFORE chunk c
    for c in range(nc):
        states.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_chunk[:, c]
    states = torch.stack(states, dim=1)                          # (B,NC,H,N,P)

    y = y + (cc[:, :, None] @ states) * torch.exp(cum)[..., None]
    y = y + p["D_skip"][:, None, None] * xh
    y = y.transpose(2, 3).reshape(bsz, nc * q, di)[:, :s]

    y = rms_norm((y * F.silu(z.float())).to(xin.dtype), p["norm_scale"],
                 cfg.norm_eps)
    out = lora_dense(y, p["out_proj"].to(y.dtype), p.get("lora"),
                     "out_proj")
    if not return_cache:
        return out
    return out, {"conv": _conv_tail(xbc_raw, cfg.ssm_conv_width),
                 "state": state}


# ----------------------------------------------------------------------
# Decode (recurrent) path
# ----------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda"):
    """Per-layer recurrent cache: conv tail (in ``dtype``) + SSM state
    (f32)."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.ssm_d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
    }


def ssd_step(p, xin: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Single-token recurrent update. xin: (B, 1, D) -> (B, 1, D), cache'
    (new tensors; ``cache`` is not written)."""
    bsz = xin.shape[0]
    di, n, h, pdim = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim)
    z, xbc, dt_raw = _split_proj(p, xin[:, 0, :], cfg)           # (B, ...)

    # the conv over the cached tail, in f32
    hist = torch.cat([cache["conv"], xbc[:, None].to(cache["conv"].dtype)],
                     dim=1)                                      # (B, W, C')
    conv = (hist.float() * p["conv_w"].float()).sum(dim=1) + p["conv_b"]
    x, bvec, cvec = torch.split(F.silu(conv), [di, n, n], dim=-1)
    xh = x.reshape(bsz, h, pdim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"]))

    state = (da[..., None, None] * cache["state"]
             + (dt[..., None] * bvec[:, None])[..., None] * xh[:, :, None])
    y = (cvec[:, None, None] @ state)[:, :, 0]                   # (B, H, P)
    y = (y + p["D_skip"][:, None] * xh).reshape(bsz, 1, di)

    y = rms_norm((y * F.silu(z.float())[:, None]).to(xin.dtype),
                 p["norm_scale"], cfg.norm_eps)
    out = lora_dense(y, p["out_proj"].to(y.dtype), p.get("lora"),
                     "out_proj")
    return out, {"conv": hist[:, 1:], "state": state}
