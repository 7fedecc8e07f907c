"""Serve a FedLDF-trained LLM on the PyTorch port: federated fine-tuning
(scan mode, the large-model path) then batched greedy decoding with the
KV cache (the port of ``examples/serve_llm.py``).

    PYTHONPATH=src python examples/serve_llm_torch.py --arch mamba2-780m \\
        --rounds 3 [--device cpu]

Every parameter is trained (no partition). On the card each client's
Eq. 3 divergence is one ``sqdiff_rowsum`` call and its Eq. 5 streaming
one ``masked_accumulate`` launch; an attention arch's every pass runs the
flash-attention kernel. Runs on the card unless ``--device cpu``.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import lm_federated, make_lm_dataset
from repro_torch.federated import FLConfig, run_training
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm

NUM_SEQ, SEQ_LEN = 128, 48
N_CLIENTS = 6
PROMPTS, PROMPT_LEN = 4, 16


def reduced_f32(arch: str):
    """The arch's reduced variant (same family wiring, CPU-sized) in
    f32."""
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32",
                               compute_dtype="float32")


def fl_task(cfg):
    """The fine-tuning task: ``(tokens, federated data, FLConfig)``,
    non-IID domain data over 6 clients, K=3, top-n 1, B=4, scan mode."""
    toks, domains = make_lm_dataset(num_sequences=NUM_SEQ, seq_len=SEQ_LEN,
                                    vocab=cfg.vocab_size, seed=0)
    data = lm_federated(toks, domains, num_clients=N_CLIENTS)
    fl = FLConfig(algo="fedldf", num_clients=N_CLIENTS, clients_per_round=3,
                  top_n=1, lr=0.05, mode="scan", batch_per_client=4)
    return toks, data, fl


def finetune(cfg, params, data, fl, rounds: int, device, verbose=True):
    """Federated fine-tuning of every parameter: ``(params, log)``."""
    return run_training(params, tfm.make_lm_loss(cfg), data, fl,
                        rounds=rounds, seed=0, verbose=verbose,
                        device=device)


def frames(cfg, device):
    """An enc-dec model's (PROMPTS, PROMPT_LEN, frontend_dim) f32 frames,
    or None."""
    if not cfg.is_encdec:
        return None
    g = torch.Generator().manual_seed(1)
    return torch.randn((PROMPTS, PROMPT_LEN, cfg.frontend_dim),
                       generator=g).to(device)


def generate(params, cfg, toks, steps: int, device):
    """Greedy decoding of the first ``PROMPTS`` sequences' first
    ``PROMPT_LEN`` tokens: prefill into a cache of ``PROMPT_LEN + steps``
    slots, then ``steps - 1`` decode steps (``serve.generate``, its
    logits kept)."""
    prompts = torch.from_numpy(
        toks[:PROMPTS, :PROMPT_LEN].astype(np.int64)).to(device)
    return prompts, serve.generate(params, cfg, prompts, steps,
                                   keep_logits=True,
                                   enc_inputs=frames(cfg, device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-780m")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = reduced_f32(args.arch)
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) "
          f"on {dev}")

    # --- federated fine-tuning on non-IID domain data (scan mode) ------
    toks, data, fl = fl_task(cfg)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    params, log = finetune(cfg, params, data, fl, args.rounds, dev)
    print("uplink saved vs FedAvg:", f"{log.meter.savings_frac * 100:.1f}%")

    # --- serve the aggregated global model ------------------------------
    prompts, run = generate(params, cfg, toks, args.steps, dev)
    for i in range(2):
        print(f"prompt {prompts[i, :8].tolist()} -> gen "
              f"{run.tokens[i].tolist()}")
    return params, log, run


if __name__ == "__main__":
    main()
