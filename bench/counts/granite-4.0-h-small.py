"""The granite-4.0-h share's counts, from its configuration's shapes alone:
parameters, the FedLDF layer units, one sequence's forward FLOPs, its
attention's FLOPs and its held experts' useful FLOPs.

A layer (``bench/reference/granite-4.0-h-small.py``) is two norms, a mixer
(NoPE grouped-query attention where ``i % attn_period == attn_offset``,
the Mamba-2 SSD mixer elsewhere) and the experts: the router over all R,
the E held experts and the shared one. Then the final norm and the tied
head. A unit is a layer (of either stacked key), the embedding or the
final norm. Imports nothing.
"""
from __future__ import annotations


def _dims(m: dict) -> dict:
    di = m["ssm_expand"] * m["d_model"]
    n_attn = sum(i % m["attn_period"] == m["attn_offset"]
                 for i in range(m["num_layers"]))
    return {"d": m["d_model"], "L": m["num_layers"], "A": n_attn,
            "M": m["num_layers"] - n_attn, "H": m["num_heads"],
            "KV": m["num_kv_heads"], "hd": m["head_dim"],
            "V": m["vocab_size"], "N": m["ssm_state"],
            "P": m["ssm_head_dim"], "di": di, "nh": di // m["ssm_head_dim"],
            "W": m["ssm_conv_width"], "Q": m["ssm_chunk"],
            "E": m["num_experts"], "R": m["router_experts"],
            "k": m["moe_top_k"], "f": m["moe_d_ff"], "fs": m["shared_d_ff"]}


def _proj(z: dict) -> tuple[int, int]:
    """(attention's, the SSD mixer's) projection parameters a layer."""
    attn = z["d"] * z["hd"] * (2 * z["H"] + 2 * z["KV"])
    ssm = z["d"] * (2 * z["di"] + 2 * z["N"] + z["nh"]) + z["di"] * z["d"]
    return attn, ssm


def param_count(model: dict) -> int:
    z = _dims(model)
    attn, ssm = _proj(z)
    conv = z["di"] + 2 * z["N"]
    ssm += z["W"] * conv + conv + 3 * z["nh"] + z["di"]
    moe = (z["d"] * z["R"] + 3 * z["E"] * z["d"] * z["f"]
           + 3 * z["d"] * z["fs"])
    return (z["A"] * attn + z["M"] * ssm + z["L"] * (moe + 2 * z["d"])
            + z["V"] * z["d"] + z["d"])


def num_units(model: dict) -> int:
    return model["num_layers"] + 2          # one a layer, embed, final


def attention_flops(model: dict, seq: int) -> int:
    """One sequence's causal attention products, QKᵀ and PV over the
    causal pairs only, in every attention layer."""
    z = _dims(model)
    return z["A"] * 2 * 2 * (seq * (seq + 1) // 2) * z["hd"] * z["H"]


def expert_flops(model: dict, seq: int) -> float:
    """One sequence's useful FLOPs of the held experts' three products in
    every layer: the rows routed to them, T·k·E/R on average (a dropless
    layer computes T rows an expert; the rest are padding)."""
    z = _dims(model)
    rows = seq * z["k"] * z["E"] / z["R"]
    return z["L"] * rows * 3 * 2 * z["d"] * z["f"]


def forward_flops(model: dict, data: dict) -> float:
    """One sequence's forward FLOPs: 2 × the parameters of every matrix
    product per token (the projections, the router, the shared expert,
    the tied head; the embedding is a lookup), the held experts' useful
    rows (:func:`expert_flops`), the depthwise convolution's
    multiply-adds, attention's two products over the causal pairs only,
    and the SSD dual form's products per chunk."""
    z, seq = _dims(model), data["seq_len"]
    attn, ssm = _proj(z)
    dense = (z["A"] * attn + z["M"] * ssm
             + z["L"] * (z["d"] * z["R"] + 3 * z["d"] * z["fs"])
             + z["V"] * z["d"])
    conv = z["M"] * 2 * z["W"] * (z["di"] + 2 * z["N"])
    chunks = -(-seq // z["Q"])
    q = z["Q"]
    ssd = chunks * (2 * q * q * z["N"]                        # C·Bᵀ
                    + 2 * q * q * z["P"] * z["nh"]            # intra-chunk y
                    + 2 * 2 * q * z["N"] * z["P"] * z["nh"])  # states, y
    return ((2 * dense + conv) * seq + expert_flops(model, seq)
            + attention_flops(model, seq) + z["M"] * ssd)
