"""The benchmark's own arithmetic: the card's peaks, a round's model FLOPs,
and the least bytes and operations of the kernels the per-layer metrics
read. Computed from the configuration and the traffic alone (shapes), never
from what the program reports.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, dense: 67 TFLOP/s
in f32 outside the tensor cores (the rounds run in f32 with TF32 off, so
this is their ceiling), 3.35 TB/s of HBM3.
"""
from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


# ----------------------------------------------------------------------
# parameters and units
# ----------------------------------------------------------------------
def vgg_layers(model: dict) -> list[tuple[int, int, int]]:
    """(spatial side, c_in, c_out) of each convolution."""
    side, cin, out = model["image_size"], model["in_channels"], []
    for i, cout in enumerate(model["channels"]):
        out.append((side, cin, cout))
        if i in model["pool_after"]:
            side //= 2
        cin = cout
    return out


def vgg_fc_in(model: dict) -> int:
    side = model["image_size"] // 2 ** len(model["pool_after"])
    return side * side * model["channels"][-1]


def lm_dims(m: dict) -> dict:
    di = m["ssm_expand"] * m["d_model"]
    return {"d": m["d_model"], "L": m["num_layers"], "H": m["num_heads"],
            "KV": m["num_kv_heads"], "hd": m["head_dim"], "F": m["d_ff"],
            "V": m["vocab_size"], "N": m["ssm_state"],
            "P": m["ssm_head_dim"], "di": di, "nh": di // m["ssm_head_dim"],
            "W": m["ssm_conv_width"], "Q": m["ssm_chunk"]}


def param_count(cfg: dict) -> int:
    m = cfg["model"]
    if cfg["kind"] == "image_classifier":
        convs = sum(9 * cin * cout + 3 * cout
                    for _, cin, cout in vgg_layers(m))
        return convs + vgg_fc_in(m) * m["num_classes"] + m["num_classes"]
    z = lm_dims(m)
    conv = z["di"] + 2 * z["N"]
    attn = z["d"] * z["hd"] * (2 * z["H"] + 2 * z["KV"])
    ssm = (z["d"] * (2 * z["di"] + 2 * z["N"] + z["nh"]) + z["W"] * conv
           + conv + 3 * z["nh"] + z["di"] + z["di"] * z["d"])
    block = 2 * z["d"] + attn + ssm + 3 * z["d"] * z["F"]
    return z["L"] * block + 2 * z["V"] * z["d"] + z["d"]


def num_units(cfg: dict) -> int:
    m = cfg["model"]
    if cfg["kind"] == "image_classifier":
        return len(m["channels"]) + 1
    return m["num_layers"] + 2          # one a block, embed, final


# ----------------------------------------------------------------------
# model FLOPs
# ----------------------------------------------------------------------
def vgg_forward_flops(model: dict) -> int:
    """One image's forward multiply-adds × 2: convolutions and the fc."""
    convs = sum(2 * side * side * 9 * cin * cout
                for side, cin, cout in vgg_layers(model))
    return convs + 2 * vgg_fc_in(model) * model["num_classes"]


def lm_forward_flops(model: dict, seq: int) -> int:
    """One sequence's forward FLOPs: 2 × the parameters of every matrix
    product (all but the embedding table, which is a lookup) per token,
    attention's two products over the causal pairs only, and the SSD dual
    form's products per chunk."""
    z = lm_dims(model)
    matmul_params = param_count({"kind": "lm", "model": model}) \
        - z["V"] * z["d"]
    pairs = seq * (seq + 1) // 2
    attn = 2 * 2 * pairs * z["hd"] * z["H"]
    chunks = -(-seq // z["Q"])
    q = z["Q"]
    ssd = chunks * (2 * q * q * z["N"]                        # C·Bᵀ
                    + 2 * q * q * z["P"] * z["nh"]            # intra-chunk y
                    + 2 * 2 * q * z["N"] * z["P"] * z["nh"])  # states, y
    return 2 * matmul_params * seq + z["L"] * (attn + ssd)


def round_model_flops(cfg: dict, traffic: dict) -> float:
    """A round's model FLOPs: forward and backward (3 × forward) of every
    trained sample, plus the forward of the round's share of the held-out
    evaluation. The scan round's recompute of local training is not model
    work and is not counted."""
    fl, m = traffic["fl"], cfg["model"]
    trained = fl["clients_per_round"] * fl["batch_per_client"] \
        * fl["local_steps"]
    if cfg["kind"] == "image_classifier":
        fwd = vgg_forward_flops(m)
        evals = traffic["data"]["num_test"]
    else:
        fwd = lm_forward_flops(m, traffic["data"]["seq_len"])
        evals = traffic["data"]["eval_sequences"]
    return 3.0 * fwd * trained + fwd * evals / traffic["eval_every"]


def attention_flops_per_round(cfg: dict, traffic: dict) -> float:
    """The causal attention kernel's FLOPs (QKᵀ and PV over the causal
    pairs) of every forward launch a round: each local step's forward, once
    more in the scan round's recompute, and the round's share of the
    evaluation's forward."""
    if cfg["kind"] != "lm":
        return 0.0
    z, fl = lm_dims(cfg["model"]), traffic["fl"]
    seq = traffic["data"]["seq_len"]
    per_seq = z["L"] * 2 * 2 * (seq * (seq + 1) // 2) * z["hd"] * z["H"]
    passes = 2 if fl["mode"] == "scan" else 1
    trained = fl["clients_per_round"] * fl["batch_per_client"] \
        * fl["local_steps"] * passes
    evals = traffic["data"]["eval_sequences"] / traffic["eval_every"]
    return per_seq * (trained + evals)


# ----------------------------------------------------------------------
# the FL kernels' least bytes (each input read once, each output written
# once; PERF.md's kernel table counts them so)
# ----------------------------------------------------------------------
def fl_kernel_bytes_per_round(cfg: dict, traffic: dict) -> dict:
    """Least bytes a round of each FL kernel group, by kernel name as the
    kernel groups file lists them: Eq. 3 (``sqdiff``), the scan round's
    Eq. 5 add (``masked_accumulate``), the error-feedback uplink
    (``fused_uplink_ef``)."""
    fl = traffic["fl"]
    p, u, k = param_count(cfg), num_units(cfg), fl["clients_per_round"]
    model = 4 * p
    out = {}
    if fl["mode"] == "vmap":
        out["sqdiff"] = (k + 1) * model + 4 * k * u
        comp = fl.get("compression")
        if comp and comp.get("error_feedback"):
            # levels (int8), v, old and new residual (f32) of K rows, the
            # numerator, the shared (K, U) scales, weights and gates
            out["fused_uplink_ef"] = k * p * (1 + 4 + 4 + 4) + model \
                + 3 * 4 * k * u
    else:
        # per client: phase 1's divergence (1 row), phase 2's f32 add
        out["sqdiff"] = k * (2 * model + 4 * u)
        out["masked_accumulate"] = k * (3 * model + 4 * u)
    return out
