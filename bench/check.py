"""The check that decides ``correct``: the program's first rounds against
the plain reference's, from the same weights, data and draws.

Set-up drives the program through the first ``check_rounds`` rounds with
the window's own call and feed: one ``run_training_scan`` call a round,
each resumed with ``start_round`` and ``server_state`` from the last, as
the window's blocks are; the window continues from there. Each call's
model and state are copied to the host. Once the window has closed and the
program's state is freed, the reference follows the same rounds step by
step: round 1 from the weights made again from the seed (bit for bit the
program's start), each later round from the program's own model and
error-feedback store after the round before. So every round is judged
from the same input on both sides; a reference that ran its own three
rounds would compare the amplified rounding of the later steps (at lr
0.05 the VGG cells' loss jumps from 2.8 to 9–22 after round 1, and the
change after three rounds then reads up to 8e-2 of a leaf in sound runs).

Compared, with each leaf's gap over the larger of the reference's norm of
that leaf and of the median leaf, at the worst leaf and round:

- ``loss_gap``: each round's loss, |program − reference| / |reference|;
- ``update_gap``: each round's update ΔP = P_{t+1} − P_t (the Eq. 5
  aggregate the server applies; lr × the pseudo-gradient), the gap of the
  two norms;
- ``update_diff``: ‖ΔP(program) − ΔP(reference)‖ of the leaf: it sees a
  layer aggregated from other clients (Eq. 4) or weighted otherwise (Eq.
  5), which norms alone can miss;
- ``uplink_bytes_gap``: each round's uplink bytes as the program's comm
  ledger reports them against the exact bytes in the ledger's documented
  arithmetic (the f64 payload rounded to f32 once, plus the f32 feedback);
  an exact comparison;
- ``ef_rows_gap`` (error feedback): the gap of the norms of each leaf of
  the N-client residual store after each round (the rows kernel 4 wrote).

Leaves whose reference update is under a thousandth of the median leaf's
(a convolution's bias before batch normalisation: nought but rounding) are
left out of the model's numbers by that rule, not by name. A cell's limits
file (``bench/limits/<cell>.json``) names the numbers it compares.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

from bench.reference import fl as ref_fl

QUIET = 1e-3          # a leaf below this share of the median update is out
FAILED = 1e30         # a number that could not be read (not finite)


@dataclasses.dataclass
class Observed:
    """What one side produced over the check's rounds, on the host."""
    losses: list[float]            # each round's loss
    uplink: list[float]            # each round's uplink bytes as reported
    models: list[dict]             # path -> the model after each round
    stores: list[Optional[dict]]   # path -> the EF store after each round
    check_s: float = 0.0           # seconds spent on the check's copies


def _pairs(tree) -> list:
    return ref_fl.leaves(tree)


def _host(tree) -> Optional[dict]:
    if tree is None:
        return None
    return {p: v.detach().to("cpu", copy=True) for p, v in _pairs(tree)}


def _store(state) -> Optional[dict]:
    return (state or {}).get("client", {}).get("residual")


# ----------------------------------------------------------------------
# the program's side, in set-up
# ----------------------------------------------------------------------
def observe_program(task, run_scan: Callable):
    """Drive the program through the check's rounds, one call a round:
    ``run_scan(params, rounds, start_round, server_state) -> (params,
    log)`` is the window's own call. Returns ``(observed, params, state,
    rounds done)`` to start the window from."""
    params, state = task.weights(), None
    out = Observed([], [], [], [])
    for t in range(task.traffic["check_rounds"]):
        params, log = run_scan(params, 1, t, state)
        state = log.final_state
        out.losses += list(log.losses)
        out.uplink += [round(u * 1e6) for u in log.uplink_mb]
        start = time.perf_counter()
        out.models.append(_host(params))
        out.stores.append(_host(_store(state)))
        out.check_s += time.perf_counter() - start
    return out, params, state, task.traffic["check_rounds"]


# ----------------------------------------------------------------------
# the reference's side, after the window
# ----------------------------------------------------------------------
def _round(task, t: int, params: dict, store: Optional[dict], prec: str,
           half_batch: bool):
    """Reference round ``t`` from ``params`` and the N-row ``store``:
    ``(out, new store)``."""
    ds, draws, fl = task.dataset, task.draws, task.traffic["fl"]
    clients = [int(c) for c in draws.clients(t)]
    batches = [ds.batch(c, draws.rows(t, c)) for c in clients]
    sizes = [float(s) for s in ds.part_sizes.tolist()]
    rows = ([ref_fl.tree_of((p, s[c]) for p, s in store.items())
             for c in clients] if store is not None else None)
    out = ref_fl.fl_round(task.ref_loss(prec), params, batches,
                          [sizes[c] for c in clients], fl, rows, half_batch)
    if store is not None:
        store = {p: s.clone() for p, s in store.items()}
        for i, c in enumerate(clients):
            for p, v in _pairs(out["ef_rows"][i]):
                store[p][c] = v
    return out, store


def _empty_store(task, params: dict) -> Optional[dict]:
    comp = task.traffic["fl"].get("compression")
    if not (comp and comp["error_feedback"]):
        return None
    n = task.traffic["fl"]["num_clients"]
    return {p: torch.zeros((n, *v.shape), dtype=torch.float32,
                           device=v.device) for p, v in _pairs(params)}


def _ledger_bytes(payload: int, feedback: int) -> float:
    """A round's uplink as the comm ledger keeps it: the exact payload
    rounded to f32, plus the f32 feedback bytes, in f32."""
    return float(np.float32(np.float32(payload) + np.float32(feedback)))


def observe_reference(task, prec: str = "f32",
                      half_batch: bool = False) -> Observed:
    """The reference over the check's rounds on its own trajectory, kept
    as :func:`observe_program` keeps the program's: the check's control
    (``prec="tf32"``) and its fault (``half_batch``) stand in the program's
    place through it."""
    params = task.weights()
    store = _empty_store(task, params)
    out = Observed([], [], [], [])
    for t in range(task.traffic["check_rounds"]):
        res, store = _round(task, t, params, store, prec, half_batch)
        params = res["params"]
        out.losses.append(float(res["loss"]))
        out.uplink.append(_ledger_bytes(res["uplink_payload"],
                                        res["uplink_feedback"]))
        out.models.append(_host(params))
        out.stores.append(None if store is None else
                          {p: v.to("cpu", copy=True) for p, v in store.items()})
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _gaps(got: dict, want: dict, keep) -> list[float]:
    med = statistics.median(want.values())
    return [abs(got[p] - want[p]) / max(want[p], med, 1e-30) for p in keep]


def numbers(task, prog: Observed) -> dict:
    """Every number of ``prog`` (the program, or the control in its place)
    against the f32 reference, which follows it round by round."""
    dev = task.device
    params = task.weights()
    store = _empty_store(task, params)
    loss, upd, diff, ef, up = [], [], [], [], []
    for t in range(len(prog.losses)):
        if t:
            params = ref_fl.tree_of(
                (p, v.to(dev)) for p, v in prog.models[t - 1].items())
            if prog.stores[t - 1] is not None:
                store = {p: v.to(dev) for p, v in prog.stores[t - 1].items()}
        res, ref_store = _round(task, t, params, store, "f32", False)
        ref_loss = float(res["loss"])
        loss.append(abs(prog.losses[t] - ref_loss) / abs(ref_loss))
        up.append(abs(prog.uplink[t] - _ledger_bytes(
            res["uplink_payload"], res["uplink_feedback"])))
        r_norm, p_norm, d_norm = {}, {}, {}
        for p, new in _pairs(res["params"]):
            old = ref_fl._get(params, p)
            mine = prog.models[t][p].to(dev)
            r_norm[p] = _norm(new - old)
            p_norm[p] = _norm(mine - old)
            d_norm[p] = _norm(mine - new)
            del mine
        med = statistics.median(r_norm.values())
        keep = [p for p, v in r_norm.items() if v >= QUIET * med]
        upd += _gaps(p_norm, r_norm, keep)
        diff += [d_norm[p] / max(r_norm[p], med) for p in keep]
        if ref_store is not None:
            want = {p: _norm(v) for p, v in ref_store.items()}
            got = prog.stores[t]
            ef += (_gaps({p: _norm(v) for p, v in got.items()}, want,
                         list(want)) if got is not None else [FAILED])
        del res, ref_store
    out = {"loss_gap": max(loss), "update_gap": max(upd),
           "update_diff": max(diff), "uplink_bytes_gap": max(up)}
    if ef:
        out["ef_rows_gap"] = max(ef)
    for k, v in out.items():     # a NaN compares false against any limit
        if not math.isfinite(v):
            out[k] = FAILED
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    the limits name is within its limit."""
    table = {k: {"value": nums.get(k, FAILED), "limit": limits[k]}
             for k in limits}
    return all(v["value"] <= v["limit"] for v in table.values()), table
