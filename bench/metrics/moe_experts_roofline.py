"""The held experts' share of their roofline, in %: their useful FLOPs a
round at the f32 peak over the device time under ``moe.experts``
(``moe_experts_ms``). Useful FLOPs are the routed rows' only
(``expert_flops`` of ``bench/counts/<config>.py``: T·k·E/R rows an
expert), of every forward that runs them: each local step's, again in the
scan round's second pass, again in the backward's recompute under
``remat_blocks``, and the round's share of the evaluation's forward. A
dropless layer computes T rows an expert, so the padding reads as lost
time. ``None`` where the program opens no ``moe.experts`` span. Layer:
experts. Moves ``round_ms``."""
from bench import spans, spec, yardstick


def useful_flops_per_round(cfg: dict, traffic: dict) -> float:
    fl, data = traffic["fl"], traffic["data"]
    per_seq = spec.counts(cfg["name"]).expert_flops(cfg["model"],
                                                    data["seq_len"])
    passes = 2 if fl["mode"] == "scan" else 1
    if traffic.get("model", {}).get("remat_blocks"):
        passes *= 2
    trained = fl["clients_per_round"] * fl["batch_per_client"] \
        * fl["local_steps"] * passes
    evals = data["eval_sequences"] / traffic["eval_every"]
    return per_seq * (trained + evals)


def read(trace, run):
    by = trace.by_span
    ms = None if by is None else spans.subtree_device_ms(by, run.rounds,
                                                         "moe.experts")
    if not ms:
        return None
    seconds = ms / 1e3
    return (100.0 * useful_flops_per_round(run.cfg, run.traffic)
            / yardstick.F32_FLOPS / seconds)
