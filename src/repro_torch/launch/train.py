"""FL training launcher, port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --task cifar \\
        --algo fedldf --rounds 100 [--paper-scale] [--ckpt out/global.npz]
    PYTHONPATH=src python -m repro_torch.launch.train --task lm \\
        --arch qwen3-1.7b --reduced --algo fedldf --rounds 20

The cifar task is the paper's own experiment (§III-A): ``--paper-scale``
trains full-width VGG-9 with ``configs.vgg9_fl`` (N=50, K=20, n=4, B=32,
lr 0.05) on 50,000 synthetic images, otherwise the reduced VGG-9 on 4,000.
The lm task runs FedLDF over any assigned architecture (``--reduced`` for
the small variant). Runs on ``--device`` (``cuda`` unless ``--device cpu``);
initial weights come from a ``torch.Generator`` seeded with ``--seed``, the
port's stream (JAX's threefry draws are not reproduced). Prints the
``verbose=True`` progress lines and ``comm summary:`` with
:meth:`CommMeter.summary`'s keys.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ARCH_IDS, get_config, vgg9_fl
from repro_torch.data import (FederatedData, dirichlet_partition,
                              iid_partition, lm_federated, make_image_dataset,
                              make_lm_dataset)
from repro_torch.federated import ALGOS, FLConfig, run_training
from repro_torch.models import cnn
from repro_torch.models import transformer as tf


def train_cifar(args) -> None:
    dev = torch.device(args.device)
    if args.paper_scale:
        cfg = cnn.VGGConfig()
        fl = dataclasses.replace(vgg9_fl(args.algo), algo=args.algo)
        n_train, n_test = 50_000, 10_000
    else:
        cfg = cnn.VGGConfig().reduced()
        fl = FLConfig(algo=args.algo, num_clients=20, clients_per_round=10,
                      top_n=2, lr=args.lr, mode="vmap", batch_per_client=16)
        n_train, n_test = 4_000, 800
    train, test = make_image_dataset(num_train=n_train, num_test=n_test,
                                     seed=args.seed)
    splitter = (functools.partial(dirichlet_partition, alpha=1.0)
                if args.non_iid else iid_partition)
    parts = splitter(train.ys, fl.num_clients, seed=args.seed)
    data = FederatedData(train.xs, train.ys, parts)
    test_batch = {"images": torch.from_numpy(test.xs).to(dev),
                  "labels": torch.from_numpy(test.ys).to(dev)}

    def loss_fn(p, b):
        return cnn.classify_loss(p, cfg, b)

    def eval_fn(p):
        with torch.no_grad():
            return 1.0 - float(cnn.accuracy(p, cfg, test_batch))

    params = cnn.init_params(cfg, torch.Generator().manual_seed(args.seed),
                             dev)
    params, log = run_training(params, loss_fn, data, fl, rounds=args.rounds,
                               eval_fn=eval_fn, eval_every=args.eval_every,
                               seed=args.seed, verbose=True, device=dev)
    print("comm summary:", log.meter.summary())
    if args.ckpt:
        save_pytree(args.ckpt, params)
        print("saved global model to", args.ckpt)


def train_lm(args) -> None:
    dev = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32",
                                  compute_dtype="float32")
    toks, domains = make_lm_dataset(num_sequences=512, seq_len=args.seq_len,
                                    vocab=cfg.vocab_size, seed=args.seed)
    data = lm_federated(toks, domains, num_clients=8)
    fl = FLConfig(algo=args.algo, num_clients=8, clients_per_round=4,
                  top_n=2, lr=args.lr, mode=args.mode, batch_per_client=4)
    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    params, log = run_training(params, tf.make_lm_loss(cfg), data, fl,
                               rounds=args.rounds, seed=args.seed,
                               verbose=True, device=dev)
    print("comm summary:", log.meter.summary())
    if args.ckpt:
        save_pytree(args.ckpt, params)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("cifar", "lm"), default="cifar")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--algo", choices=ALGOS, default="fedldf")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--mode", choices=("vmap", "scan"), default="scan")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    (train_cifar if args.task == "cifar" else train_lm)(args)


if __name__ == "__main__":
    main()
