"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held to on the card, and
the path :mod:`repro_torch.kernels.ops` takes for tensors on the CPU. They
mirror ``src/repro/kernels/ref.py`` (f32 accumulation, f32 result), with
the extensions the kernels have: ``b`` may be broadcast over client
blocks, the accumulate may write in place, and each kernel has a grouped
``*_leaves`` form over a list of leaves (the divergence's per-unit sums
add a unit's leaves in list order from 0). The uplink sums run over
the client axis in a fixed ascending order (the reference's einsum leaves
the order open), so the CUDA kernels can match them bit for bit.

:func:`flash_attention` follows the Pallas kernel
(``src/repro/kernels/flash_attention.py``), not its oracle: a row that no
key may attend to gives 0 there, where :func:`ref_attention` (the port of
the reference's oracle) gives the mean of V. :func:`flash_attention_bwd`
is its analytic gradient, the backward of the kernel's differentiable form
(``kernels/flash_attention.py:FlashAttentionFn``) on the CPU and on the
card alike: the Pallas kernel has no backward to port.
:func:`flash_attention_split` models the decode kernel's split-KV
partial-and-merge arithmetic; only the tests use it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def sqdiff_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row sum of squared differences, the inner reduction of Eq. 3.

    a: (R, C); b: (R_b, C) with R a multiple of R_b, so row r of ``a`` is
    compared with row ``r % R_b`` of ``b`` (R_b = R is the plain case).
    Returns (R,) float32.
    """
    rows, cols = a.shape
    d = (a.float().reshape(rows // b.shape[0], b.shape[0], cols)
         - b.float())
    return (d * d).sum(dim=-1).reshape(rows)


def sqdiff_rowsum_leaves(a: list[torch.Tensor], b: list[torch.Tensor],
                         units: list[tuple[int, int]]) -> torch.Tensor:
    """Per-unit sums of :func:`sqdiff_rowsum` over every (a, b) leaf, as the
    CUDA kernel computes them in one call.

    a[i]: (K·n_i, C_i); b[i]: (n_i, C_i); ``units[i] = (off_i, n_i)``, row
    k·n_i + j of leaf i belonging to unit off_i + j of client k. Returns
    (K, U) float32, U = max(off_i + n_i), each unit's leaves added in list
    order starting from 0, as ``UnitMap.sq_divergence`` composes them.
    """
    if not len(a) == len(b) == len(units) or not a:
        raise ValueError(f"sqdiff_rowsum_leaves needs equal, non-empty "
                         f"lists; got {len(a)}, {len(b)}, {len(units)}")
    kk = a[0].shape[0] // units[0][1]
    out = torch.zeros((kk, max(off + n for off, n in units)),
                      dtype=torch.float32, device=a[0].device)
    for x, y, (off, n) in zip(a, b, units):
        out[:, off:off + n] = out[:, off:off + n] + sqdiff_rowsum(
            x, y).reshape(kk, n)
    return out


def masked_accumulate(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``acc + w[:, None] * x``, the Eq. 5 per-layer weighted accumulation.

    acc: (R, C) float32; x: (R, C) any float dtype; w: (R,). Returns (R, C)
    float32, written into ``out`` when given (``out=acc`` accumulates in
    place, as the CUDA kernel does).
    """
    return torch.add(acc, w.float()[:, None] * x.float(), out=out)


def masked_accumulate_leaves(accs: list[torch.Tensor],
                             xs: list[torch.Tensor],
                             ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """:func:`masked_accumulate` in place over every (acc, x, w) leaf, as
    the CUDA kernel does in one launch. Returns ``accs``."""
    for acc, x, w in zip(accs, xs, ws, strict=True):
        masked_accumulate(acc, x, w, out=acc)
    return accs


def fused_uplink(levels: torch.Tensor, scales: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[k,r]·scales[k,r]·levels[k,r,:]``: dequantization and the
    Eq. 5 numerator of a packed uplink.

    levels: (K, R, C) integer levels; scales, w: (K, R). Returns (R, C)
    float32. The sum runs over k in ascending order, one rounded product
    and one rounded add at a time, as the CUDA kernel does, so the two
    agree bit for bit.
    """
    num = torch.zeros(levels.shape[1:], dtype=torch.float32,
                      device=levels.device)
    for k in range(levels.shape[0]):
        recon = levels[k].float() * scales[k].float()[:, None]
        num = num + w[k].float()[:, None] * recon
    return num


def fused_uplink_leaves(levels: list[torch.Tensor],
                        scales: list[torch.Tensor],
                        ws: list[torch.Tensor]) -> list[torch.Tensor]:
    """:func:`fused_uplink` of every (levels, scales, w) leaf, as the CUDA
    kernel does in one launch."""
    return [fused_uplink(lv, s, w)
            for lv, s, w in zip(levels, scales, ws, strict=True)]


def fused_uplink_ef(levels: torch.Tensor, scales: torch.Tensor,
                    w: torch.Tensor, gate: torch.Tensor, v: torch.Tensor,
                    e_old: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_uplink` plus the error-feedback residual update.

    levels: (K, R, C); scales, w, gate: (K, R); v (= Δ + e) and e_old:
    (K, R, C) in any float dtype. Returns ``(num (R, C), new_res (K, R,
    C))`` float32 with ``new_res = gate·(v − recon) + (1 − gate)·e_old``,
    so rows with ``gate == 0`` keep ``e_old`` exactly.
    """
    recon = levels.float() * scales.float()[..., None]
    num = torch.zeros(levels.shape[1:], dtype=torch.float32,
                      device=levels.device)
    for k in range(levels.shape[0]):
        num = num + w[k].float()[:, None] * recon[k]
    g = gate.float()[..., None]
    res = g * (v.float() - recon) + (1.0 - g) * e_old.float()
    return num, res


def fused_uplink_ef_leaves(levels: list[torch.Tensor],
                           v: list[torch.Tensor], e_old: list[torch.Tensor],
                           units: list[tuple[int, int]],
                           scales: torch.Tensor, w: torch.Tensor,
                           gate: torch.Tensor
                           ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:func:`fused_uplink_ef` of every leaf, as the CUDA kernel does in one
    launch: leaf i's rows are units ``off_i .. off_i + n_i − 1`` of the
    round's (K, U) ``scales``, ``w`` and ``gate``."""
    if not len(levels) == len(v) == len(e_old) == len(units):
        raise ValueError(f"fused_uplink_ef_leaves needs equal lists; got "
                         f"{len(levels)}, {len(v)}, {len(e_old)}, "
                         f"{len(units)}")
    return [fused_uplink_ef(lv, scales[:, off:off + n], w[:, off:off + n],
                            gate[:, off:off + n], vv, ee)
            for lv, vv, ee, (off, n) in zip(levels, v, e_old, units)]


def _attention_mask(sq: int, skv: int, causal: bool, window: int,
                    kv_len: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: query row i may attend to key j (positions are the
    indices, as in the Pallas kernel)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    ok = k_pos < kv_len
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """GQA softmax(Q·Kᵀ/√hd)·V with the Pallas kernel's masks and result.

    Two layouts, as the CUDA kernel takes them:

    - the kernel's own: q (BH, Sq, hd), k and v (BKV, Skv, hd), BH =
      BKV·G, and row ``bh`` reads K/V row ``bh // G``;
    - the model's (``attend``): q (B, Sq, H, hd), k and v (B, Skv, KV,
      hd), H = KV·G, and head ``h`` reads K/V head ``h // G``.

    Row i may attend to key j when ``j < kv_len`` (default Skv), ``j <= i``
    if ``causal`` and ``j > i - window`` if ``window > 0``. Products and
    sums are f32 and the scale is applied after the dot. A row with no key
    gives 0. Returns q's shape in q.dtype.
    """
    if q.ndim == 4:
        b, sq, h, hd = q.shape
        skv, kvh = k.shape[1], k.shape[2]
        o = flash_attention(
            q.transpose(1, 2).reshape(b * h, sq, hd),
            k.transpose(1, 2).reshape(b * kvh, skv, hd),
            v.transpose(1, 2).reshape(b * kvh, skv, hd),
            causal=causal, window=window, kv_len=kv_len)
        return o.reshape(b, h, sq, hd).transpose(1, 2).contiguous()
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    g = bh // bkv
    kv_len = skv if kv_len is None else kv_len
    s = torch.bmm(q.float().reshape(bkv, g * sq, hd),
                  k.float().transpose(1, 2)) * (1.0 / math.sqrt(hd))
    s = s.reshape(bkv, g, sq, skv)
    ok = _attention_mask(sq, skv, causal, window, kv_len, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.bmm(p.reshape(bkv, g * sq, skv), v.float())
    o = o.reshape(bkv, g, sq, hd) / l.clamp_min(1e-30)
    return o.reshape(bh, sq, hd).to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        kv_len: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The analytic gradient of :func:`flash_attention` in the model's
    layout (q, out, dout (B, Sq, H, hd); k, v (B, Skv, KV, hd)), in f32:
    the masked probabilities P are recomputed from q and k, then

        dV = Σ_g Pᵀ·dO,   dP = dO·Vᵀ,   dS = P∘(dP − rowsum(dO∘O)),
        dQ = dS·K·scale,  dK = Σ_g dSᵀ·Q·scale,

    with head ``h`` reading KV head ``h // G`` (Σ_g adds a KV head's G
    query heads). A row with no visible key has P = 0, so it gets zero
    gradients. Returns (dq, dk, dv), each in its input's dtype.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kv_len = skv if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, sq, kvh, g, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, kf) * scale
    ok = _attention_mask(sq, skv, causal, window, kv_len, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    do = dout.float().reshape(b, sq, kvh, g, hd)
    delta = (do * out.float().reshape(b, sq, kvh, g, hd)).sum(dim=-1)
    dv = torch.einsum("bkgqc,bqkgd->bckd", p, do)
    dp = torch.einsum("bqkgd,bckd->bkgqc", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds, qf) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, chunk: int, causal: bool = True,
                          window: int = 0,
                          kv_len: int | None = None) -> torch.Tensor:
    """:func:`flash_attention` as the decode kernel computes it
    (``csrc/flash_attention_decode.cu``), in the same layouts.

    The visible keys ``[0, k_end)``, ``k_end = min(kv_len, Sq)`` if
    ``causal`` else ``kv_len``, are cut into splits of ``chunk`` keys. Each
    split keeps its partial ``(m, l, o)`` in f32, in the log2 domain: ``x =
    (q·k)·scale·log2(e)``, ``m = max x`` (-inf when every key is masked),
    ``p = exp2(x − m)`` (m taken as 0 then), ``l = Σ p``, ``o = Σ p·v``.
    The merge weighs split s by ``exp2(m_s − max m)``, in split order, and
    returns ``Σ w·o / Σ w·l``, or 0 for a row that sees no key.
    """
    if q.ndim == 4:
        b, sq, h, hd = q.shape
        skv, kvh = k.shape[1], k.shape[2]
        o = flash_attention_split(
            q.transpose(1, 2).reshape(b * h, sq, hd),
            k.transpose(1, 2).reshape(b * kvh, skv, hd),
            v.transpose(1, 2).reshape(b * kvh, skv, hd), chunk=chunk,
            causal=causal, window=window, kv_len=kv_len)
        return o.reshape(b, h, sq, hd).transpose(1, 2).contiguous()
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    g = bh // bkv
    kv_len = skv if kv_len is None else kv_len
    k_end = min(kv_len, sq) if causal else kv_len
    x = torch.bmm(q.float().reshape(bkv, g * sq, hd),
                  k.float().transpose(1, 2)) * (LOG2E / math.sqrt(hd))
    ok = _attention_mask(sq, skv, causal, window, kv_len, q.device)
    x = torch.where(ok, x.reshape(bkv, g, sq, skv), -math.inf)
    vf = v.float()
    parts = []
    for lo in range(0, max(k_end, 1), chunk):
        hi = min(lo + chunk, k_end)
        if hi <= lo:                    # kv_len = 0: one empty split
            parts.append((torch.full((bkv, g, sq, 1), -math.inf,
                                     device=q.device),
                          torch.zeros((bkv, g, sq, 1), device=q.device),
                          torch.zeros((bkv, g, sq, hd), device=q.device)))
            continue
        xs = x[..., lo:hi]
        m = xs.amax(dim=-1, keepdim=True)
        p = torch.exp2(xs - torch.where(m == -math.inf, 0.0, m))
        o = torch.bmm(p.reshape(bkv, g * sq, hi - lo), vf[:, lo:hi])
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      o.reshape(bkv, g, sq, hd)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_all = torch.where(m_all == -math.inf, 0.0, m_all)
    l_sum = torch.zeros_like(parts[0][1])
    o_sum = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = torch.exp2(m - m_all)
        l_sum = l_sum + w * l
        o_sum = o_sum + w * o
    o = torch.where(l_sum > 0, o_sum / l_sum.clamp_min(1e-30), 0.0)
    return o.reshape(bh, sq, hd).to(q.dtype)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """The reference's oracle (``flash_attention.py:ref_attention``): plain
    softmax over the masked scores, in the kernel's (BH, Sq, hd) layout.
    A fully-masked row gets uniform weights, so it gives the mean of V."""
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    group = bh // bkv
    kr = k.repeat_interleave(group, dim=0).float()
    vr = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr) / (hd ** 0.5)
    ok = _attention_mask(sq, skv, causal, window, skv, q.device)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vr).to(q.dtype)
