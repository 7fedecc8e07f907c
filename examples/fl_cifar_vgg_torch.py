"""End-to-end driver on the PyTorch port: the paper's experiment (§III) at
configurable scale (the port of ``examples/fl_cifar_vgg.py``).

Trains VGG on the synthetic CIFAR-10-like task with FedLDF and the FedAvg /
Random / HDFL / FedADP baselines, IID or Dirichlet(α=1), and reports the
error-vs-communication trade-off (paper Figs. 3-4) plus the Theorem-1 bound
for the same (n, K). Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/fl_cifar_vgg_torch.py --rounds 60
    PYTHONPATH=src python examples/fl_cifar_vgg_torch.py --paper-scale \\
        --rounds 1000
"""
import argparse
import functools

import torch

from repro_torch.core.convergence import BoundParams, asymptotic_gap
from repro_torch.data import (FederatedData, dirichlet_partition,
                              iid_partition, make_image_dataset)
from repro_torch.federated import FedADPOptions, FLConfig, run_training
from repro_torch.models import cnn

LR = 0.08


def setting(paper_scale: bool):
    """(cfg, N, K, n, train images, test images, B) of the paper's setup
    or of the reduced one."""
    if paper_scale:
        return cnn.VGGConfig(), 50, 20, 4, 50_000, 10_000, 32
    return cnn.VGGConfig().reduced(), 20, 10, 2, 4_000, 800, 16


def fl_config(algo, n_clients, k, n, batch) -> FLConfig:
    return FLConfig(algo=algo, num_clients=n_clients, clients_per_round=k,
                    top_n=n, lr=LR, mode="vmap", batch_per_client=batch,
                    algo_options=(FedADPOptions(keep=n / k)
                                  if algo == "fedadp" else None))


def eval_error(cfg, test_batch):
    """1 − accuracy on ``test_batch``, as a Python float."""
    def err(p):
        with torch.no_grad():
            return 1.0 - float(cnn.accuracy(p, cfg, test_batch))
    return err


def theorem1_gap(num_layers: int, n: int, k: int) -> float:
    """Theorem 1's asymptotic gap bound at the example's constants."""
    return asymptotic_gap(BoundParams(
        beta=1.0, xi1=0.05, xi2=0.02, grad_bound=1.0, eta=0.05,
        num_layers=num_layers, n=n, k=k))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--algos", default="fedldf,fedavg,random")
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg, n_clients, k, n, n_train, n_test, batch = setting(args.paper_scale)
    train, test = make_image_dataset(num_train=n_train, num_test=n_test,
                                     seed=args.seed)
    split = (functools.partial(dirichlet_partition, alpha=1.0)
             if args.non_iid else iid_partition)
    parts = split(train.ys, n_clients, seed=args.seed)
    data = FederatedData(train.xs, train.ys, parts)
    test_batch = {"images": torch.from_numpy(test.xs).to(dev),
                  "labels": torch.from_numpy(test.ys).to(dev)}

    def loss_fn(p, b):
        return cnn.classify_loss(p, cfg, b)

    print(f"setting: {'paper' if args.paper_scale else 'reduced'} "
          f"N={n_clients} K={k} n={n} "
          f"{'Dirichlet(1)' if args.non_iid else 'IID'} on {dev}")
    final = {}
    for algo in args.algos.split(","):
        params = cnn.init_params(
            cfg, torch.Generator().manual_seed(args.seed), dev)
        _, log = run_training(params, loss_fn, data,
                              fl_config(algo, n_clients, k, n, batch),
                              rounds=args.rounds,
                              eval_fn=eval_error(cfg, test_batch),
                              eval_every=max(1, args.rounds // 8),
                              seed=args.seed, device=dev)
        err = log.test_errors[-1][1]
        up = log.meter.uplink_bytes / 1e6
        final[algo] = log
        print(f"  {algo:8s} final_err={err:.4f} uplink={up:9.1f}MB "
              f"savings={log.meter.savings_frac * 100:5.1f}%")

    if "fedldf" in final and "fedavg" in final:
        l1, l2 = final["fedldf"], final["fedavg"]
        e1, e2 = l1.test_errors[-1][1], l2.test_errors[-1][1]
        u1, u2 = l1.meter.uplink_bytes, l2.meter.uplink_bytes
        print(f"\nFedLDF vs FedAvg: Δerr={e1 - e2:+.4f} at "
              f"{(1 - u1 / u2) * 100:.0f}% less uplink (paper: ≈equal "
              f"error, 80%)")
    bound = theorem1_gap(cfg.num_layers, n, k)
    print(f"Theorem-1 asymptotic gap bound for (n={n}, K={k}): {bound:.4f}")
    return final


if __name__ == "__main__":
    main()
