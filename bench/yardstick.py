"""The benchmark's own arithmetic: the card's peaks, a round's model FLOPs,
and the least bytes and operations of the kernels the per-layer metrics
read. Computed from the configuration and the traffic alone (shapes), never
from what the program reports.

A configuration's own counts (parameters, layer units, one sample's
forward FLOPs and, for a model with attention, one sequence's attention
FLOPs) are in ``bench/counts/<config>.py``, found by the configuration's
name (:func:`bench.spec.counts`). What is kept here is the round's
arithmetic over them: training at 3 × the forward, the evaluation's share,
the scan round's second pass, the FL kernels' bytes.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, dense: 67 TFLOP/s
in f32 outside the tensor cores (the rounds run in f32 with TF32 off, so
this is their ceiling), 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from bench import spec

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# the traffic's ``data`` key that holds the evaluation's samples, by task
EVAL_SAMPLES = {"image_classifier": "num_test", "lm": "eval_sequences"}


def counts(cfg: dict):
    """The configuration's counts module, ``bench/counts/<name>.py``."""
    return spec.counts(cfg["name"])


def param_count(cfg: dict) -> int:
    return counts(cfg).param_count(cfg["model"])


def num_units(cfg: dict) -> int:
    return counts(cfg).num_units(cfg["model"])


# ----------------------------------------------------------------------
# model FLOPs
# ----------------------------------------------------------------------
def round_model_flops(cfg: dict, traffic: dict) -> float:
    """A round's model FLOPs: forward and backward (3 × forward) of every
    trained sample, plus the forward of the round's share of the held-out
    evaluation. The scan round's recompute of local training is not model
    work and is not counted."""
    fl = traffic["fl"]
    trained = fl["clients_per_round"] * fl["batch_per_client"] \
        * fl["local_steps"]
    fwd = counts(cfg).forward_flops(cfg["model"], traffic["data"])
    evals = traffic["data"][EVAL_SAMPLES[cfg["kind"]]]
    return 3.0 * fwd * trained + fwd * evals / traffic["eval_every"]


def attention_flops_per_round(cfg: dict, traffic: dict) -> float:
    """The causal attention kernel's FLOPs (QKᵀ and PV over the causal
    pairs) of every forward launch a round: each local step's forward, once
    more in the scan round's recompute, and the round's share of the
    evaluation's forward. 0 for a model without attention."""
    c = counts(cfg)
    if not hasattr(c, "attention_flops"):
        return 0.0
    fl = traffic["fl"]
    per_seq = c.attention_flops(cfg["model"], traffic["data"]["seq_len"])
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
