"""Round telemetry walkthrough on the PyTorch port: taps -> JSONL ledger
-> terminal monitor.

    PYTHONPATH=src python examples/telemetry_run_torch.py [--rounds N]
        [--ledger PATH] [--device cpu]

Runs a small synthetic-CIFAR federated task (reduced VGG-9, N=10, K=5)
under ``FLConfig(telemetry=TelemetryConfig(...))`` for three strategies
(fedldf, fedlama, fedlp) on both multi-round drivers (the host loop with
the engine's streams, ``run_training(sampler="device")``, and the
device-resident engine ``run_training_scan``), then a seventh segment, a
FedLDF run (K=4) over a 2-D ('clients', 'model') mesh of 4 ranks (2 × 2,
started with ``repro_torch.launch.mesh.spawn``: gloo ranks on the CPU, or
sharing the card), all appending run segments to ONE JSONL ledger (rank 0
of the mesh writes its segment). It then renders every segment with the
port's monitor (``repro_torch.launch.monitor``): per-layer divergence and
selection heat tables, strategy-state trajectories (FedLAMA's adapted
intervals) and the bytes/savings/loss summary. Runs on the card unless
``--device cpu``.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.data import FederatedData, iid_partition, make_image_dataset
from repro_torch.federated import (FLConfig, TelemetryConfig, run_training,
                                   run_training_scan)
from repro_torch.launch import monitor
from repro_torch.launch.mesh import make_client_mesh, spawn
from repro_torch.models import cnn

N_CLIENTS, K = 10, 5


def fl(algo, clients_per_round=K, **kw):
    return FLConfig(algo=algo, num_clients=N_CLIENTS,
                    clients_per_round=clients_per_round, top_n=2, lr=0.05,
                    batch_per_client=8, **kw)


def tele(ledger, run_id):
    # full_selection=False keeps the records lean for this demo; the
    # per-layer taps (divergence, sel_count, state_*) stay on
    return TelemetryConfig(ledger_path=ledger, run_id=run_id,
                           full_selection=False)


def mesh_segment(rank, device, rounds, ledger, params, xs, ys, parts):
    """One rank of the 2 x 2 mesh run: clients split 2 ways, the params
    FSDP-sharded 2 ways along 'model'."""
    mesh = make_client_mesh(model=2, device=device)
    if mesh.device.type == "cpu":     # 4 ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    cfg = cnn.VGGConfig().reduced()
    _, log = run_training(
        params_from_numpy(params, mesh.device),
        lambda p, b: cnn.classify_loss(p, cfg, b),
        FederatedData(xs, ys, parts),
        fl("fedldf", clients_per_round=4, mesh=mesh,
           telemetry=tele(ledger, "fedldf/mesh2x2")),
        rounds=rounds, seed=0, sampler="device", device=device)
    return log.losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: a temp file)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ledger = args.ledger or os.path.join(
        tempfile.mkdtemp(prefix="telemetry_run_"), "ledger.jsonl")
    dev = torch.device(args.device)

    cfg = cnn.VGGConfig().reduced()
    train, _ = make_image_dataset(num_train=400, num_test=16, seed=0)
    data = FederatedData(train.xs, train.ys,
                         iid_partition(train.ys, N_CLIENTS, seed=0))
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), dev)

    def loss_fn(p, b):
        return cnn.classify_loss(p, cfg, b)

    # ---- three strategies x two drivers, one ledger ----
    for algo in ("fedldf", "fedlama", "fedlp"):
        _, log = run_training(params, loss_fn, data,
                              fl(algo, telemetry=tele(ledger,
                                                      f"{algo}/host")),
                              rounds=args.rounds, seed=0, sampler="device",
                              device=dev)
        assert all(np.isfinite(l) for l in log.losses)
        _, log = run_training_scan(params, loss_fn, data,
                                   fl(algo, telemetry=tele(ledger,
                                                           f"{algo}/scan")),
                                   rounds=args.rounds, seed=0, device=dev)
        assert all(np.isfinite(l) for l in log.losses)

    # ---- FedLDF over a 2-D mesh: 4 ranks, clients sharded 2-way,
    # params FSDP-sharded 2-way along 'model' ----
    losses = spawn(mesh_segment, 4, (args.device, args.rounds, ledger,
                                     params_to_numpy(params), train.xs,
                                     train.ys, data.parts))
    assert all(np.isfinite(l) for l in losses[0])

    # ---- render everything the runs ledgered ----
    print(f"\n=== {ledger} ===")
    n = monitor.render(ledger, bins=40)
    print(f"\n{n} run segments rendered from {ledger}")
    assert n == 7, n   # 3 algos x 2 drivers + the mesh run


if __name__ == "__main__":
    main()
