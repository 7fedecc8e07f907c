"""Quickstart on the PyTorch port: one FedLDF round step by step, then a
multi-round run (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--rounds N]
        [--device cpu]

Walks the paper's Algorithm 1 with the port's public API: local training
(Eq. 2), per-layer divergence (Eq. 3, one ``sqdiff_rowsum`` kernel call
over every leaf on the card), top-n selection (Eq. 4), layer-wise
aggregation (Eq. 5/6), and the communication ledger; then hands the same
model to ``run_training_scan``, which enqueues the whole multi-round
schedule on the device with one host pull a block. Runs on the card
unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch.core import (UnitMap, aggregate_stacked, round_comm,
                              topn_divergence)
from repro_torch.data import (FederatedData, iid_partition,
                              make_image_dataset)
from repro_torch.federated import (FLConfig, make_local_update,
                                   run_training_scan)
from repro_torch.models import cnn
from repro_torch.optim import sgd

K, N_TOP = 5, 2
LR = 0.05


def round_step(cfg, global_params, batch, data_sizes, n_top=N_TOP):
    """One FedLDF round on client-stacked ``batch`` leaves (K, B, ...) and
    the clients' ``data_sizes`` (K,): the locals and their losses (Eq. 2),
    the (K, U) divergence matrix (Eq. 3), the selection (Eq. 4), the new
    global model (Eq. 5/6) and the round's communication."""
    umap = UnitMap.build(global_params)
    local_update = make_local_update(
        lambda p, b: cnn.classify_loss(p, cfg, b), sgd(LR), local_steps=1)
    locals_, losses = torch.func.vmap(local_update, in_dims=(None, 0))(
        global_params, batch)
    # K·U scalars uplink: one kernel call over every client and leaf
    divs = umap.divergence(locals_, global_params)
    selection = topn_divergence(divs, n_top)
    new_global = aggregate_stacked(locals_, umap, selection, data_sizes,
                                   fallback=global_params)
    return {"locals": locals_, "losses": losses, "divergence": divs,
            "selection": selection, "params": new_global,
            "comm": round_comm(selection, umap)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10,
                    help="rounds for the multi-round engine demo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- setup: a small CNN and K=5 clients ----------------------------
    cfg = cnn.VGGConfig().reduced()
    global_params = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                                    dev)
    umap = UnitMap.build(global_params)
    print(f"model: {cfg.name} on {dev}, L={umap.num_units} layer-units "
          f"({umap.total_params / 1e3:.0f}k params)")
    print("units:", umap.names)

    g = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn((K, 8, 32, 32, 3), generator=g).to(dev),
             "labels": torch.randint(0, cfg.num_classes, (K, 8),
                                     generator=g).to(dev)}
    data_sizes = torch.tensor([100.0, 150.0, 80.0, 120.0, 100.0],
                              device=dev)                       # |D_k|

    # --- Steps 1-5: local training, divergence, top-n, aggregation ----
    out = round_step(cfg, global_params, batch, data_sizes)
    print(f"\nlocal losses: {[f'{l:.3f}' for l in out['losses'].tolist()]}")
    print(f"divergence matrix (K×U):\n"
          f"{torch.round(out['divergence'], decimals=4).cpu()}")
    print(f"selection (exactly n={N_TOP} per column):\n"
          f"{out['selection'].int().cpu()}")

    # --- the point of it all: the communication ledger -----------------
    comm = out["comm"]
    print(f"\nuplink: {float(comm['uplink_total']) / 1e3:.1f} kB "
          f"(FedAvg would be {float(comm['fedavg_uplink']) / 1e3:.1f} kB) "
          f"-> {float(comm['savings_frac']) * 100:.1f}% saved")
    print("done — new global model ready for the next round.")

    # --- multi-round: the device-resident engine -----------------------
    # run_training_scan enqueues the whole schedule (sampling, batch
    # gathering, local training, selection, aggregation, comm accounting)
    # on the device, with one host pull a block of rounds
    print(f"\n--- {args.rounds} rounds with run_training_scan ---")
    train, _ = make_image_dataset(num_train=500, num_test=16, seed=2)
    data = FederatedData(train.xs, train.ys,
                         iid_partition(train.ys, 10, seed=0))
    flcfg = FLConfig(algo="fedldf", num_clients=10, clients_per_round=K,
                     top_n=N_TOP, lr=LR, mode="vmap", batch_per_client=8)
    _, log = run_training_scan(out["params"],
                               lambda p, b: cnn.classify_loss(p, cfg, b),
                               data, flcfg, rounds=args.rounds, seed=0,
                               device=dev)
    print(f"losses: {[f'{l:.3f}' for l in log.losses]}")
    print(f"total uplink {log.meter.uplink_bytes / 1e6:.2f} MB over "
          f"{log.meter.rounds} rounds "
          f"({log.meter.savings_frac * 100:.1f}% saved vs FedAvg)")
    return log


if __name__ == "__main__":
    main()
