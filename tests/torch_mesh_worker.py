"""Rank programs of the client-mesh tests: each runs in one process of a
spawned world (``repro_torch.launch.mesh.spawn``, gloo on the CPU, or on
a card in ``tests/test_torch_gpu.py``) and returns numpy results for the
parent to compare. No JAX here: the children import ``repro_torch``
only, and the reference's draws arrive as numpy arrays
(:class:`ArrayDraws`).

The task is the quickstart's reduced VGG-9 at N=8, K=4, n=2, B=8.
"""
import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core.units import UnitMap, tree_leaves, tree_map
from repro_torch.core.wire import CompressionConfig
from repro_torch.data import ClientShards, FederatedData
from repro_torch.federated import (FLConfig, run_training,
                                   run_training_scan)
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models import cnn
from repro_torch.telemetry import TelemetryConfig

N, K, TOP_N, B = 8, 4, 2, 8
CFG = cnn.VGGConfig().reduced()


def loss_fn(p, batch):
    return cnn.classify_loss(p, CFG, batch)


def fl_config(mesh=None, algo="fedldf", **kw):
    return FLConfig(algo=algo, num_clients=N, clients_per_round=K,
                    top_n=TOP_N, mode="vmap", batch_per_client=B,
                    mesh=mesh, **kw)


SETTING_A = CompressionConfig(bits=8, error_feedback=True)


class ArrayDraws:
    """Injected draws: ``rounds[t]`` holds round t's ``clients`` (K,),
    ``indices`` (K, B) and ``uniform`` arrays (the reference's, drawn by
    the parent)."""

    def __init__(self, rounds):
        self.rounds = rounds

    def __call__(self, t):
        return _ArrayRound(self.rounds[t])


class _ArrayRound:
    def __init__(self, d):
        self.d = d

    def clients(self, num_clients, k, num_groups=1):
        return torch.from_numpy(self.d["clients"])

    def indices(self, sizes, batch):
        return torch.from_numpy(self.d["indices"])

    def uniform(self, shape):
        u = self.d["uniform"]
        assert u.shape == tuple(shape), (u.shape, shape)
        return torch.from_numpy(u)


def _np(tree):
    return None if tree is None else params_to_numpy(tree)


def _run(mesh, fn, *args, **kw):
    """(params, log) of a driver call and the mesh's counters for it."""
    mesh.reset_counts()
    p, log = fn(*args, **kw)
    return {"params": _np(p), "losses": list(log.losses),
            "uplink": log.meter.uplink_bytes, "rounds": log.meter.rounds,
            "state": (None if log.final_state is None else
                      {"client": {n_: _np(e) for n_, e in
                                  (log.final_state.get("client") or {})
                                  .items()}}),
            "counts": mesh.counts()}


def _random_tree(seed, device):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(3, 5, generator=g).to(device),
            "b": {"c": torch.randn(7, generator=g).to(device),
                  "d": torch.randn((), generator=g).to(device)},
            "e": {"f": torch.randn(2, 2, generator=g).to(device)}}


def _flat(tree):
    return np.concatenate([np.asarray(x.cpu(), np.float64).reshape(-1)
                           for x in tree_leaves(tree)])


def card_world(rank, task):
    """A world of gloo ranks on the card (ranks may share one): every
    collective on CUDA tensors through the staging buffer, then fedldf and
    setting A through the engine, with the kernels' launches a rank."""
    from repro_torch.kernels import ops
    mesh = make_client_mesh()
    d = mesh.size
    dev = mesh.device
    out = {"rank": rank, "size": d, "backend": mesh.backend,
           "stage": mesh.stage, "device": str(dev)}
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) \
        + 10 * rank
    out["gather"] = np.asarray(mesh.all_gather_rows(x).cpu())
    out["reduce"] = np.asarray(mesh.all_reduce_flat(x.clone()).cpu())
    out["group"] = np.asarray(mesh.group_all_reduce(x.clone(), d).cpu())
    out["shift"] = np.asarray(mesh.ring_shift(x, 1).cpu())
    out["psum"] = _flat(agg.hierarchical_psum(_random_tree(100 + rank, dev),
                                              mesh, 1))
    out["psum_want"] = sum(_flat(_random_tree(100 + r, "cpu"))
                           for r in range(d))
    out["counts"] = mesh.counts()
    params = params_from_numpy(task["params"], "cpu")
    data = FederatedData(task["xs"], task["ys"], task["parts"])
    for name, fl in (("flat", fl_config(mesh)),
                     ("A", fl_config(mesh, compression=SETTING_A))):
        ops.reset_launch_counts()
        seen = []   # the params after each round (an eval block a round)
        out[name] = _run(mesh, run_training_scan, params, loss_fn, data, fl,
                         rounds=2, seed=0, device="cuda", eval_every=1,
                         eval_fn=lambda p: seen.append(_np(p)) or 0.0)
        out[name]["launches"] = {k_: v for k_, v in
                                 ops.launch_counts().items() if v}
        out[name]["per_round"] = seen
    return out


def raise_on_rank_one(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def world(rank, task):
    """Every check of one world: ``task`` holds the data, the params, the
    injected draws, the device and the ledger path (numpy / str)."""
    torch.set_num_threads(1)
    dev = task["device"]
    mesh = make_client_mesh(device=dev)
    d = mesh.size
    params = params_from_numpy(task["params"], "cpu")
    data = FederatedData(task["xs"], task["ys"], task["parts"])
    draws = ArrayDraws(task["draws"])
    kw = dict(device=dev)
    out = {"rank": rank, "size": d, "backend": mesh.backend,
           "stage": mesh.stage}

    # the reference's draws: flat, two-tier, setting A, FedADP
    out["flat"] = _run(mesh, run_training_scan, params, loss_fn, data,
                       fl_config(mesh), rounds=3, seed=0, draws=draws, **kw)
    gs = 1 if d == 2 else 2
    out["tier"] = _run(mesh, run_training_scan, params, loss_fn, data,
                       fl_config(mesh, agg_group_size=gs), rounds=3, seed=0,
                       draws=draws, **kw)
    out["A"] = _run(mesh, run_training_scan, params, loss_fn, data,
                    fl_config(mesh, compression=SETTING_A), rounds=3,
                    seed=0, draws=draws, **kw)
    out["fedadp"] = _run(mesh, run_training_scan, params, loss_fn, data,
                         fl_config(mesh, "fedadp"), rounds=2, seed=0,
                         draws=draws, **kw)

    # the keyed streams: host driver against engine, telemetry on / off
    fl_a = fl_config(mesh, compression=SETTING_A)
    out["engine"] = _run(mesh, run_training_scan, params, loss_fn, data,
                         fl_a, rounds=3, seed=5, **kw)
    out["host"] = _run(mesh, run_training, params, loss_fn, data, fl_a,
                       rounds=3, seed=5, sampler="device", **kw)
    out["host_np"] = _run(mesh, run_training, params, loss_fn, data,
                          fl_config(mesh), rounds=2, seed=5, sampler="host",
                          **kw)
    tele = fl_config(mesh, compression=SETTING_A,
                     agg_group_size=1 if d == 2 else 2,
                     telemetry=TelemetryConfig(
                         ledger_path=task["ledger"], run_id=f"mesh{d}"))
    out["tele"] = _run(mesh, run_training_scan, params, loss_fn, data, tele,
                       rounds=3, seed=5, **kw)
    out["tele_off"] = _run(mesh, run_training_scan, params, loss_fn, data,
                           fl_config(mesh, compression=SETTING_A,
                                     agg_group_size=1 if d == 2 else 2),
                           rounds=3, seed=5, **kw)

    if d == 2:
        # sample sharding against the replicated placement of the same
        # affinity layout (grouped draw both ways), bit for bit
        aff = ClientShards.from_federated(data).with_affinity(d)
        out["rep_aff"] = _run(mesh, run_training_scan, params, loss_fn, aff,
                              fl_config(mesh), rounds=3, seed=2, **kw)
        shard = fl_config(mesh, shard_samples=True)
        out["shard"] = _run(mesh, run_training_scan, params, loss_fn, data,
                            shard, rounds=3, seed=2, **kw)
        out["shard_host"] = _run(mesh, run_training, params, loss_fn, data,
                                 shard, rounds=3, seed=2, sampler="device",
                                 **kw)
        full = ClientShards.from_federated(data)
        rep, shd = aff.place(mesh), full.place(mesh, shard_samples=True)
        out["bytes"] = (rep.bytes_per_device(), shd.bytes_per_device())
        # the same (clients, j) of this rank's group through the loader's
        # layout, the replicated and the sample-sharded affinity layouts
        cpg = N // d
        clients = torch.tensor([rank * cpg + 1, rank * cpg], device=dev)
        j = torch.tensor([[0, 3, 1], [2, 2, 0]], device=dev)
        out["gather"] = [{n_: np.asarray(v.cpu()) for n_, v in
                          sh.gather(clients, j).items()}
                         for sh in (full.place(mesh), rep, shd)]

    if d == 4:
        # submeshes of world ranks 0-1 (every rank builds them: new_group
        # is collective): the 1-D mesh of 2 on the reference's draws, and
        # the 1 x 2 grid against the one-rank mesh; ranks 2-3 hold meshes
        # whose rounds raise
        for name, mesh_ in (("sub", make_client_mesh(2, device=dev)),
                            ("sub_grid", make_client_mesh(2, model=2,
                                                          device=dev))):
            out[f"{name}_shape"] = (mesh_.shape, mesh_.member)
            try:
                out[name] = _run(mesh_, run_training_scan, params, loss_fn,
                                 data, fl_config(mesh_), rounds=3, seed=0,
                                 draws=draws, **kw)
            except ValueError as e:
                out[name] = str(e)
        if rank < 2:
            one = make_client_mesh(1, device=dev)
            out["sub_one"] = _run(one, run_training_scan, params, loss_fn,
                                  data, fl_config(one), rounds=3, seed=0,
                                  draws=draws, **kw)

    # hierarchical_psum against a flat all-reduce on random trees, and
    # against the float64 sum of every rank's tree
    trees = [_random_tree(100 + r, dev) for r in range(d)]
    want = sum(_flat(t) for t in trees)
    res = {}
    for g in range(1, d + 1):
        if d % g:
            continue
        got = agg.hierarchical_psum(trees[rank], mesh, g)
        res[g] = _flat(got)
    res["flat"] = _flat(agg.mesh_psum(trees[rank], mesh))
    # the tier-1 reduce over a block of the whole clients axis
    res["group"] = np.asarray(mesh.group_all_reduce(
        torch.from_numpy(_flat(trees[rank]).astype(np.float32)).to(dev),
        d).cpu(), np.float64)
    out["psum"] = {"want": want, "got": res}

    # round_comm over local rows and aggregate_stacked(mesh=)
    p_dev = tree_map(lambda l: l.to(dev), params)
    umap = UnitMap.build(p_dev)
    g = torch.Generator().manual_seed(7)
    sel = (torch.rand(K, umap.num_units, generator=g) < 0.5).float()
    sel[0] = 1.0
    sizes = torch.arange(1, K + 1, dtype=torch.float32)
    stacked = tree_map(lambda l: l[None] + torch.randn(
        (K,) + tuple(l.shape), generator=g).to(dev) * 0.1, p_dev)
    kloc = K // d
    lo = rank * kloc
    loc = slice(lo, lo + kloc)
    out["comm"] = [{n_: float(v) for n_, v in comm_mod.round_comm(
        s.to(dev), umap, mesh=m).items()}
        for s, m in ((sel[loc], mesh), (sel, None))]
    out["aggregate"] = [_np(agg.aggregate_stacked(
        tree_map(lambda l: l[rows], stacked), umap, sel[rows].to(dev),
        sizes[rows].to(dev), fallback=p_dev, mesh=m))
        for rows, m in ((loc, mesh), (slice(None), None))]
    return out
