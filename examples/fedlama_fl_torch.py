"""FedLAMA on the PyTorch port: layer-wise adaptive aggregation intervals
(arXiv:2110.10302; the port of ``examples/fedlama_fl.py``).

    PYTHONPATH=src python examples/fedlama_fl_torch.py [--rounds N]
        [--tau T] [--lam L] [--device cpu]

FedLAMA keeps three replicated (U,) vectors in strategy state — per-layer-
unit ``ttl`` (rounds until the next synchronisation), ``interval``
(τ_u ∈ {τ', λτ'}), and ``disc`` (the discrepancy estimate that drives the
interval assignment). Low-drift layers are synchronised every λτ' rounds
instead of every τ', so uplink drops well below FedAvg while high-drift
layers stay fresh.

This example runs the device-resident engine on the synthetic
CIFAR-10-like task, prints the adapted interval distribution, then
checkpoints mid-run with ``save_server_state`` (params + strategy state in
one npz) and resumes with ``start_round``/``server_state``, asserting
that the continuation is bit-identical to the uninterrupted run. Runs on
the card unless ``--device cpu``.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import load_server_state, save_server_state
from repro_torch.core.units import tree_leaves
from repro_torch.data import (FederatedData, iid_partition,
                              make_image_dataset)
from repro_torch.federated import FedLAMAOptions, FLConfig, run_training_scan
from repro_torch.models import cnn


def fl_config(tau: int, lam: int) -> FLConfig:
    return FLConfig(algo="fedlama", num_clients=10, clients_per_round=5,
                    top_n=2, lr=0.05, batch_per_client=8,
                    algo_options=FedLAMAOptions(tau=tau, lam=lam))


def resume_drift(params, loss_fn, data, fl: FLConfig, rounds: int, device,
                 full_params, draws=None) -> float:
    """Run ``rounds // 2`` rounds, save → load the server state, resume
    for the rest, and return the largest |difference| of the result from
    ``full_params`` (the uninterrupted run's)."""
    half = rounds // 2
    p_half, l_half = run_training_scan(params, loss_fn, data, fl,
                                       rounds=half, seed=0, device=device,
                                       draws=draws)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "server.npz")
        save_server_state(path, p_half, l_half.final_state)
        p_loaded, state_loaded = load_server_state(path, device=device)
    p_res, _ = run_training_scan(p_loaded, loss_fn, data, fl,
                                 rounds=rounds - half, seed=0,
                                 start_round=half,
                                 server_state=state_loaded, device=device,
                                 draws=draws)
    return max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(full_params), tree_leaves(p_res)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--tau", type=int, default=2,
                    help="base aggregation interval τ'")
    ap.add_argument("--lam", type=int, default=2,
                    help="interval stretch λ for low-discrepancy layers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = cnn.VGGConfig().reduced()
    train, _ = make_image_dataset(num_train=500, num_test=16, seed=0)
    data = FederatedData(train.xs, train.ys,
                         iid_partition(train.ys, 10, seed=0))
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), dev)

    def loss_fn(p, b):
        return cnn.classify_loss(p, cfg, b)

    fl = fl_config(args.tau, args.lam)
    p_full, log = run_training_scan(params, loss_fn, data, fl,
                                    rounds=args.rounds, seed=0, device=dev)
    assert all(np.isfinite(l) for l in log.losses)

    intervals = log.final_state["global"]["interval"].cpu().numpy()
    base, long_ = float(args.tau), float(args.tau * args.lam)
    print(f"losses: {[f'{l:.3f}' for l in log.losses]}")
    print(f"adapted intervals: {int((intervals == base).sum())} units @ "
          f"τ'={base:.0f}, {int((intervals == long_).sum())} units @ "
          f"λτ'={long_:.0f}")
    print(f"uplink {log.meter.uplink_bytes / 1e6:.2f} MB over "
          f"{log.meter.rounds} rounds "
          f"({log.meter.savings_frac * 100:.1f}% saved vs FedAvg)")

    # --- checkpoint the stateful run mid-way and resume it ---
    drift = resume_drift(params, loss_fn, data, fl, args.rounds, dev, p_full)
    assert drift == 0.0, f"resume drifted from uninterrupted run: {drift}"
    print(f"save → load → resume at round {args.rounds // 2}: "
          f"bit-identical to the uninterrupted {args.rounds}-round run")
    return log


if __name__ == "__main__":
    main()
