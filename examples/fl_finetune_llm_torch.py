"""Federated LLM fine-tuning with the PyTorch port: adapter-only uplink over
a frozen base (the port of ``examples/fl_finetune_llm.py``).

The trainable partition (``FLConfig(partition=...)``) plus LoRA adapters
(``repro_torch.models.lora``) turn the FL engine into a federated
fine-tuning engine: the base transformer stays on the device, clients
train and upload only the low-rank factors, and FedLDF's Eq. 3 divergence
scores per-depth adapter units. On a CUDA card the attention of every
local step runs the flash-attention kernel (forward) with its analytic
backward in PyTorch ops.

    PYTHONPATH=src python examples/fl_finetune_llm_torch.py --rounds 2
    PYTHONPATH=src python examples/fl_finetune_llm_torch.py --device cpu

Prints a comm table comparing each algorithm's adapter uplink against the
full-model FedAvg upload of the same transformer.
"""
import argparse

import torch

from repro_torch.core.partition import partition_counts
from repro_torch.core.units import tree_leaves
from repro_torch.data import lm_federated, make_lm_dataset
from repro_torch.federated import (CompressionConfig, FedLPOptions, FLConfig,
                                   run_training)
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lora import inject_lora, lora_partition


def tiny_lm() -> ModelConfig:
    """A 4-layer toy LM — the workload shape, not the workload size."""
    return ModelConfig(name="tiny-lm", family="dense", d_model=64,
                       num_layers=4, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256, param_dtype="float32",
                       compute_dtype="float32")


def _tree_bytes(tree) -> int:
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--rank", type=int, default=2)
    ap.add_argument("--top-n", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = tiny_lm()
    n_clients, k = 8, 4
    tokens, domains = make_lm_dataset(num_sequences=320, seq_len=33,
                                      vocab=cfg.vocab_size, num_domains=8,
                                      seed=0)
    data = lm_federated(tokens[:256], domains[:256], n_clients)
    eval_batch = {"tokens": torch.from_numpy(tokens[256:, :-1]).to(dev),
                  "labels": torch.from_numpy(tokens[256:, 1:]).to(dev)}

    base = tfm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    params = inject_lora(base, args.rank, torch.Generator().manual_seed(1))
    part = lora_partition(params)
    counts = partition_counts(part, params)
    loss_fn = tfm.make_lm_loss(cfg)

    def eval_fn(p):
        with torch.no_grad():
            return float(tfm.lm_loss(p, cfg, eval_batch))

    full_up = _tree_bytes(params) * k       # full-model FedAvg, per round
    print(f"model: {cfg.name} on {dev}  trainable "
          f"{counts['trainable_params']:,} / frozen "
          f"{counts['frozen_params']:,} params "
          f"({100 * counts['trainable_bytes'] / _tree_bytes(params):.1f}% "
          f"of bytes)\n")

    runs = [
        ("fedavg_lora", dict(algo="fedavg")),
        ("fedlp_lora", dict(algo="fedlp", top_n=args.top_n,
                            algo_options=FedLPOptions(p=0.5))),
        ("fedldf_lora", dict(algo="fedldf", top_n=args.top_n)),
        ("fedldf_lora_auto", dict(algo="fedldf", top_n=args.top_n,
                                  compression=CompressionConfig(
                                      bits="auto"))),
    ]
    rows = []
    for name, kw in runs:
        fl = FLConfig(num_clients=n_clients, clients_per_round=k,
                      lr=args.lr, batch_per_client=8, partition=part, **kw)
        trained, log = run_training(params, loss_fn, data, fl,
                                    rounds=args.rounds, eval_fn=eval_fn,
                                    eval_every=max(1, args.rounds // 3),
                                    seed=0, sampler="device", device=dev)
        up = log.meter.uplink_bytes / args.rounds
        rows.append((name, up, full_up / up, eval_fn(trained)))
        print(f"  {name:<18s} done; final eval loss {rows[-1][3]:.4f}")

    print(f"\n{'algo':<18s} {'uplink/round':>14s} {'vs full FedAvg':>15s} "
          f"{'eval loss':>10s}")
    print(f"{'fedavg_full':<18s} {full_up / 1e3:>12.1f}kB {'1.0x':>15s} "
          f"{'-':>10s}")
    for name, up, ratio, ev in rows:
        print(f"{name:<18s} {up / 1e3:>12.1f}kB {ratio:>14.1f}x "
              f"{ev:>10.4f}")
    best = max(r[2] for r in rows)
    print(f"\nadapter-only uplink: {best:.0f}x below full-model upload "
          f"(frozen base never travels the wire)")


if __name__ == "__main__":
    main()
