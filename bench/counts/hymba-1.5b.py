"""The hybrid LM's counts, from its configuration's shapes alone:
parameters, the FedLDF layer units, one sequence's forward FLOPs and its
attention's FLOPs.

Every one of the L blocks is alike (``bench/reference/hymba-1.5b.py``):
two norms, grouped-query attention, the Mamba-2 SSD mixer and a SwiGLU
MLP; then the final norm and an untied head. A unit is a block, the
embedding or the final norm and head. Imports nothing.
"""
from __future__ import annotations


def _dims(m: dict) -> dict:
    di = m["ssm_expand"] * m["d_model"]
    return {"d": m["d_model"], "L": m["num_layers"], "H": m["num_heads"],
            "KV": m["num_kv_heads"], "hd": m["head_dim"], "F": m["d_ff"],
            "V": m["vocab_size"], "N": m["ssm_state"],
            "P": m["ssm_head_dim"], "di": di, "nh": di // m["ssm_head_dim"],
            "W": m["ssm_conv_width"], "Q": m["ssm_chunk"]}


def param_count(model: dict) -> int:
    z = _dims(model)
    conv = z["di"] + 2 * z["N"]
    attn = z["d"] * z["hd"] * (2 * z["H"] + 2 * z["KV"])
    ssm = (z["d"] * (2 * z["di"] + 2 * z["N"] + z["nh"]) + z["W"] * conv
           + conv + 3 * z["nh"] + z["di"] + z["di"] * z["d"])
    block = 2 * z["d"] + attn + ssm + 3 * z["d"] * z["F"]
    return z["L"] * block + 2 * z["V"] * z["d"] + z["d"]


def num_units(model: dict) -> int:
    return model["num_layers"] + 2          # one a block, embed, final


def attention_flops(model: dict, seq: int) -> int:
    """One sequence's causal attention products, QKᵀ and PV over the
    causal pairs only, in every block."""
    z = _dims(model)
    return z["L"] * 2 * 2 * (seq * (seq + 1) // 2) * z["hd"] * z["H"]


def forward_flops(model: dict, data: dict) -> int:
    """One sequence's forward FLOPs: 2 × the parameters of every matrix
    product (all but the embedding table, which is a lookup) per token,
    attention's two products over the causal pairs only, and the SSD dual
    form's products per chunk."""
    z, seq = _dims(model), data["seq_len"]
    matmul_params = param_count(model) - z["V"] * z["d"]
    chunks = -(-seq // z["Q"])
    q = z["Q"]
    ssd = chunks * (2 * q * q * z["N"]                        # C·Bᵀ
                    + 2 * q * q * z["P"] * z["nh"]            # intra-chunk y
                    + 2 * 2 * q * z["N"] * z["P"] * z["nh"])  # states, y
    return (2 * matmul_params * seq + attention_flops(model, seq)
            + z["L"] * ssd)
