"""Rank programs of the 2-D ('clients', 'model') mesh tests: each runs in
one process of a spawned world of gloo ranks on the CPU
(``repro_torch.launch.mesh.spawn``, or on a card in
``tests/test_torch_gpu.py``) and returns numpy results for the parent to
compare. No JAX here: the children import ``repro_torch`` only, and the
reference's draws arrive as numpy arrays (``ArrayDraws`` of
``tests/torch_mesh_worker.py``).

The task is ``tests/test_model_axis.py``'s: a (3072, 16) + (16, 10) MLP at
N=8, K=4, n=2, B=8 on 320 synthetic images; plus its stacked-units
variant and a reduced qwen3 with rank-2 adapters.
"""
import dataclasses
import gc

import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.units import tree_leaves, tree_map
from repro_torch.core.wire import CompressionConfig
from repro_torch.data import ClientShards, FederatedData
from repro_torch.federated import (FLConfig, make_strategy, run_training,
                                   run_training_scan)
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.launch.sharding import (fl_param_specs, init_residual_store,
                                         tree_all_gather, tree_shard_slice)
from repro_torch.models import transformer as tfm
from repro_torch.models.lora import lora_partition
from repro_torch.telemetry import TelemetryConfig
from torch_mesh_worker import ArrayDraws

N, K, TOP_N, B = 8, 4, 2, 8
GRIDS = ((2, 2), (1, 4))           # (C, M) over a world of 4
ROUNDS = {"fedldf": 4, "fedavg": 4, "int4_ef": 3, "int4": 3, "fedadp": 2,
          "stacked": 3}
LM_N, LM_K = 4, 2


def mlp_loss(p, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = torch.relu(x @ p["l1"]["w"] + p["l1"]["b"])
    logits = h @ p["head"]["w"] + p["head"]["b"]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["labels"][:, None].long()).mean()


def stacked_loss(p, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = x @ p["embed"]["w"]
    for i in range(2):
        h = torch.relu(h @ p["blocks"]["w"][i] + p["blocks"]["b"][i])
    logp = torch.log_softmax(h @ p["head"]["w"], dim=-1)
    return -logp.gather(-1, batch["labels"][:, None].long()).mean()


def fl_config(mesh=None, algo="fedldf", **kw):
    return FLConfig(algo=algo, num_clients=N, clients_per_round=K,
                    top_n=TOP_N, mode="vmap", batch_per_client=B, mesh=mesh,
                    **kw)


def run_config(name, mesh, **kw):
    """The FLConfig of a named run (see ``ROUNDS``)."""
    if name == "fedavg":
        return fl_config(mesh, "fedavg", **kw)
    if name == "fedadp":
        return fl_config(mesh, "fedadp", **kw)
    if name in ("int4_ef", "int4"):
        return fl_config(mesh, compression=CompressionConfig(
            bits=4, error_feedback=name == "int4_ef"), **kw)
    return fl_config(mesh, **kw)


def lm_config(mesh=None, partition=None):
    return FLConfig(algo="fedldf", num_clients=LM_N, clients_per_round=LM_K,
                    top_n=1, batch_per_client=4, partition=partition,
                    mesh=mesh)


def _np(tree):
    return None if tree is None else params_to_numpy(tree)


def _run(mesh, fn, *args, **kw):
    """A driver call's params, losses, uplink, final client state (the
    rank's shards) and the mesh's counters for it."""
    mesh.reset_counts()
    p, log = fn(*args, **kw)
    st = log.final_state
    return {"params": _np(p), "losses": list(log.losses),
            "uplink": log.meter.uplink_bytes, "rounds": log.meter.rounds,
            "state": (None if st is None else
                      {n_: _np(e) for n_, e in (st.get("client") or {})
                       .items()}),
            "counts": mesh.counts()}


def _mixed_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 12, generator=g),
            "b": {"c": torch.randn(5, generator=g),
                  "d": torch.randn(4, 3, 8, generator=g).to(torch.bfloat16)},
            "blocks": {"w": torch.randn(2, 6, 4, generator=g)}}


def world(rank, task):
    """Every check of the 2-D grids in one world of 4 gloo CPU ranks:
    ``task`` holds the data, the params and the reference's draws."""
    torch.set_num_threads(1)
    data = FederatedData(task["xs"], task["ys"], task["parts"])
    params = params_from_numpy(task["params"], "cpu")
    stacked = params_from_numpy(task["stacked"], "cpu")
    draws, sdraws = ArrayDraws(task["draws"]), ArrayDraws(task["sdraws"])
    one = make_client_mesh(1, device="cpu")
    out = {"rank": rank}
    for c, m in GRIDS:
        mesh = make_client_mesh(model=m, device="cpu")
        res = {"shape": dict(mesh.shape), "coords": (mesh.client_rank,
                                                     mesh.model_rank),
               "axis_names": mesh.axis_names}
        # the reference's draws: every algorithm and setting of
        # tests/test_model_axis.py
        for name, rounds in ROUNDS.items():
            if name == "stacked":
                res[name] = _run(mesh, run_training_scan, stacked,
                                 stacked_loss, data, fl_config(mesh),
                                 rounds=rounds, seed=0, draws=sdraws,
                                 device="cpu")
            else:
                res[name] = _run(mesh, run_training_scan, params, mlp_loss,
                                 data, run_config(name, mesh),
                                 rounds=rounds, seed=0, draws=draws,
                                 device="cpu")
        # the host driver and telemetry on, against the engine's fedldf
        res["host"] = _run(mesh, run_training, params, mlp_loss, data,
                           fl_config(mesh), rounds=ROUNDS["fedldf"],
                           seed=0, sampler="device", draws=draws,
                           device="cpu")
        ledger = task["ledger"].format(c=c, m=m)
        res["tele"] = _run(mesh, run_training_scan, params, mlp_loss, data,
                           fl_config(mesh, telemetry=TelemetryConfig(
                               ledger_path=ledger, run_id=f"grid{c}x{m}")),
                           rounds=ROUNDS["fedldf"], seed=0, draws=draws,
                           device="cpu")
        # resume on the same grid from the rank's shards of the EF store
        first = run_training_scan(params, mlp_loss, data,
                                  run_config("int4_ef", mesh), rounds=2,
                                  seed=0, draws=draws, device="cpu")
        res["resume"] = _run(mesh, run_training_scan, first[0], mlp_loss,
                             data, run_config("int4_ef", mesh), rounds=1,
                             start_round=2, server_state=first[1].final_state,
                             seed=0, draws=draws, device="cpu")
        if c == 2:
            # sample sharding against the replicated placement of the
            # same affinity layout (the keyed streams, grouped draw)
            aff = ClientShards.from_federated(data).with_affinity(c)
            res["rep_aff"] = _run(mesh, run_training_scan, params, mlp_loss,
                                  aff, fl_config(mesh), rounds=3, seed=2,
                                  device="cpu")
            res["shard"] = _run(mesh, run_training_scan, params, mlp_loss,
                                data, fl_config(mesh, shard_samples=True),
                                rounds=3, seed=2, device="cpu")
        if c == 1:
            # the 1-rank mesh on the same draws: C = 1 makes the column's
            # sum the identity, so the grid must give its bits
            for name in ("fedldf", "int4_ef"):
                res[f"one_{name}"] = _run(
                    one, run_training_scan, params, mlp_loss, data,
                    run_config(name, one), rounds=ROUNDS[name], seed=0,
                    draws=draws, device="cpu")
            # resume on the grid from the 1-rank mesh's whole EF store
            first = run_training_scan(params, mlp_loss, data,
                                      run_config("int4_ef", one), rounds=2,
                                      seed=0, draws=draws, device="cpu")
            res["resume_whole"] = _run(
                mesh, run_training_scan, first[0], mlp_loss, data,
                run_config("int4_ef", mesh), rounds=1, start_round=2,
                server_state=first[1].final_state, seed=0, draws=draws,
                device="cpu")
            res["lora"] = _lora(task, mesh)
        # the shards themselves
        specs = fl_param_specs(params, mesh)
        res["param_shards"] = {
            "/".join(k_): tuple(l.shape) for k_, l in _paths(
                tree_shard_slice(params, specs, m, mesh.model_rank))}
        store = init_residual_store(params, N, mesh)
        res["store"] = {"/".join(k_): (tuple(l.shape), str(l.dtype))
                        for k_, l in _paths(store)}
        sspecs = fl_param_specs(stacked, mesh)
        res["blocks_w"] = tuple(tree_shard_slice(
            stacked, sspecs, m, mesh.model_rank)["blocks"]["w"].shape)
        res["strategy_specs"] = make_strategy(run_config("int4_ef", mesh)) \
            .state_specs(params, {"client": {"residual": store}}, mesh)
        # tree_all_gather ∘ tree_shard_slice, mixed dtypes, offset 0 and 1
        tree = _mixed_tree(7)
        mesh.reset_counts()
        tspecs = fl_param_specs(tree, mesh)
        back = tree_all_gather(tree_shard_slice(tree, tspecs, m,
                                                mesh.model_rank),
                               tspecs, mesh)
        rows = tree_map(lambda l: torch.stack([l, 2 * l, -l]), tree)
        back_rows = tree_all_gather(
            tree_shard_slice(rows, tspecs, m, mesh.model_rank, offset=1),
            tspecs, mesh, offset=1)
        res["roundtrip"] = all(
            torch.equal(a, b_) and a.dtype == b_.dtype for a, b_ in
            zip(tree_leaves(tree) + tree_leaves(rows),
                tree_leaves(back) + tree_leaves(back_rows)))
        res["roundtrip_calls"] = mesh.counts()["all_gather_model"][0]
        out[(c, m)] = res
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k_ in sorted(tree):
            yield from _paths(tree[k_], prefix + (k_,))
    else:
        yield prefix, tree


def _lora(task, mesh):
    """One fedldf round of the reduced qwen3 with adapters on the grid:
    the frozen base and the adapters held as shards."""
    tcfg = task["lm_cfg"]
    tp = params_from_numpy(task["lm_params"], "cpu")
    td = task["lm_data"]
    part = lora_partition(tp)
    r = _run(mesh, run_training_scan, tp, tfm.make_lm_loss(tcfg), td,
             lm_config(mesh, part), rounds=1, seed=0,
             draws=ArrayDraws(task["lm_draws"]), device="cpu")
    trainable, frozen = part.split(tp)
    fspecs = fl_param_specs(frozen, mesh)
    r["frozen_shard_bytes"] = sum(
        l.numel() * l.element_size() for l in tree_leaves(tree_shard_slice(
            frozen, fspecs, mesh.model_size, mesh.model_rank)))
    r["frozen_bytes"] = sum(l.numel() * l.element_size()
                            for l in tree_leaves(frozen))
    r["frozen_sharded_leaves"] = sum(
        1 for s in tree_leaves(fspecs) if "model" in s)
    return r


def lm_task_config(cfg):
    """The reduced qwen3 in f32 (the parity tolerance is f32's)."""
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def card_grid(rank, task):
    """A 1 × 2 grid of 2 gloo ranks on the card: the params' and the EF
    store's bytes at rest (``torch.cuda.memory_allocated`` deltas) on the
    grid and on the 1-rank mesh, and setting A (int8 + EF) through the
    engine on both, with the kernels' launches."""
    from repro_torch.kernels import ops
    mesh = make_client_mesh(model=2)
    one = make_client_mesh(1)
    dev = mesh.device
    full = params_from_numpy(task["params"], dev)
    out = {"rank": rank, "shape": dict(mesh.shape), "stage": mesh.stage,
           "device": str(dev)}

    def allocated(fn):
        gc.collect()
        gc.disable()     # a cycle freed meanwhile would move the delta
        try:
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated(dev)
            kept = fn()
            return kept, torch.cuda.memory_allocated(dev) - a0
        finally:
            gc.enable()

    specs = fl_param_specs(full, mesh)
    kept = []
    for label, params_fn, m_ in (
            # copies: the slice hands back a replicated leaf itself
            ("grid", lambda: tree_map(torch.clone, tree_shard_slice(
                full, specs, 2, mesh.model_rank)), mesh),
            ("one", lambda: tree_map(torch.clone, full), one)):
        p_, p_bytes = allocated(params_fn)
        s_, s_bytes = allocated(lambda: init_residual_store(full, N, m_))
        out[label] = (p_bytes, s_bytes)
        kept += [p_, s_]
    del kept
    data = FederatedData(task["xs"], task["ys"], task["parts"])
    comp = CompressionConfig(bits=8, error_feedback=True)
    for label, m_ in (("grid_run", mesh), ("one_run", one)):
        ops.reset_launch_counts()
        out[label] = _run(m_, run_training_scan, full, mlp_loss, data,
                          fl_config(m_, compression=comp), rounds=2, seed=0,
                          device="cuda")
        out[label]["launches"] = {k_: v for k_, v in
                                  ops.launch_counts().items() if v}
    return out
