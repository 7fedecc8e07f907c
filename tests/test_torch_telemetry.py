"""The port's round telemetry against the reference's (``repro.telemetry``):
``TelemetryConfig``, the JSONL ledger (each package reads the other's),
the progress sink (byte for byte), the taps hook, the host driver's ledger
over 3 rounds of fedldf, fedlama, fedavg and int8 + EF, the zero-cost path
(telemetry on gives the trajectory of telemetry off, bit for bit, in every
driver), the two drivers' ledgers against each other, resume, taps in a
block that do not alias later rounds, the verbose lines, the program
spans (off, on, the tree a block and a round emit, and the trajectory
the same bit for bit either way), the profile window, the monitor (byte
for byte), and the small pieces ``launch/train.py`` needs
(``CommMeter.summary``, ``vgg9()``, ``vgg9_fl()``) and the launcher itself.

The task is the MLP of tests/test_telemetry.py (N=8, K=4, B=8).
"""
import ast
import collections
import dataclasses
import io
import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.data as jdata  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core.wire import CompressionConfig as JComp  # noqa: E402
from repro.federated import FLConfig as JFL  # noqa: E402
from repro.federated import TelemetryConfig as JTele  # noqa: E402
from repro.federated import make_strategy as jmake_strategy  # noqa: E402
from repro.federated import run_training as jrun  # noqa: E402
from repro.launch import monitor as jmonitor  # noqa: E402
from repro import telemetry as jtele  # noqa: E402
from repro.telemetry import profiling as jprof  # noqa: E402
from repro.telemetry import taps as jtaps  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import (load_server_state,  # noqa: E402
                                    save_server_state)
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core.units import UnitMap, tree_leaves  # noqa: E402
from repro_torch.core.comm import comm_acc_init  # noqa: E402
from repro_torch.core.wire import CompressionConfig  # noqa: E402
from repro_torch.data import ClientShards  # noqa: E402
from repro_torch.federated import (FLConfig, KeyedDraws,  # noqa: E402
                                   TelemetryConfig, build_round_fn,
                                   make_strategy, run_training,
                                   run_training_scan)
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.launch import monitor  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch import telemetry as ttele  # noqa: E402
from repro_torch.telemetry import profiling as tprof  # noqa: E402
from repro_torch.telemetry import taps as ttaps  # noqa: E402
from repro_torch.telemetry.ledger import _jsonable  # noqa: E402

N, K = 8, 4                 # tests/test_telemetry.py:42
LOSS_TOL = 1e-5             # tests/test_round_engine.py:61
TAP_RTOL = 2e-5             # tests/test_round_engine.py:43, relative
HOOK_RTOL = 1e-6            # the taps hook on the same numpy inputs


# ----------------------------------------------------------------------
# the MLP task of tests/test_telemetry.py, in both packages
# ----------------------------------------------------------------------
def _jparams():
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    return {"l1": {"w": jax.random.normal(ks[0], (3072, 16)) * 0.02,
                   "b": jnp.zeros((16,))},
            "head": {"w": jax.random.normal(ks[1], (16, 10)) * 0.1,
                     "b": jnp.zeros((10,))}}


def _jloss(params, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = jax.nn.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    logp = jax.nn.log_softmax(h @ params["head"]["w"] + params["head"]["b"])
    return -jnp.take_along_axis(logp, batch["labels"][:, None],
                                axis=-1).mean()


def _tloss(params, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    logp = torch.log_softmax(h @ params["head"]["w"] + params["head"]["b"],
                             dim=-1)
    return -torch.take_along_dim(logp, batch["labels"].long()[:, None],
                                 dim=-1).mean()


@pytest.fixture(scope="module")
def task():
    """(reference params, port params, reference data, port data)."""
    jtrain, _ = jdata.make_image_dataset(num_train=320, num_test=16, seed=1)
    ttrain_, _ = tdata.make_image_dataset(num_train=320, num_test=16, seed=1)
    jp = _jparams()
    return (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            jdata.FederatedData(jtrain.xs, jtrain.ys,
                                jdata.iid_partition(jtrain.ys, N, seed=0)),
            tdata.FederatedData(ttrain_.xs, ttrain_.ys,
                                tdata.iid_partition(ttrain_.ys, N, seed=0)))


# algo -> FLConfig kwargs in (reference, port)
CASES = {
    "fedldf": ({}, {}),
    "fedlama": ({"algo": "fedlama"}, {"algo": "fedlama"}),
    "fedavg": ({"algo": "fedavg"}, {"algo": "fedavg"}),
    "int8_ef": ({"compression": JComp(bits=8, error_feedback=True)},
                {"compression": CompressionConfig(bits=8,
                                                  error_feedback=True)}),
}


def _cfg(case="fedldf", mode="vmap", **kw):
    return FLConfig(num_clients=N, clients_per_round=K, top_n=2, mode=mode,
                    batch_per_client=8, **CASES[case][1], **kw)


def _jcfg(case="fedldf", **kw):
    return JFL(num_clients=N, clients_per_round=K, top_n=2, mode="vmap",
               batch_per_client=8, **CASES[case][0], **kw)


def _segments(path):
    return ttele.split_runs(ttele.read_ledger(path))


def _assert_same_params(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ======================================================================
# TelemetryConfig
# ======================================================================
@pytest.mark.parametrize("kwargs", [
    {"verbosity": "loud"}, {"profile_rounds": (5, 2)},
    {"profile_rounds": (-1, 2)}])
def test_config_rejects_what_the_reference_rejects(kwargs):
    with pytest.raises(ValueError) as want:
        JTele(**kwargs)
    with pytest.raises(ValueError) as got:
        TelemetryConfig(**kwargs)
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("kwargs", [
    {}, {"profile_rounds": (1.0, 3.0)},
    {"ledger_path": "/x/a.jsonl", "run_id": "a", "verbosity": "quiet",
     "profile_rounds": (0, 1)},
    {"taps": False, "full_selection": False, "sample_system": False}])
def test_config_fields_and_trace_key_match_reference(kwargs):
    got, want = TelemetryConfig(**kwargs), JTele(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.trace_key()) == \
        dataclasses.asdict(want.trace_key())
    assert got.wants_ledger == want.wants_ledger
    assert isinstance(hash(got), int)
    assert hash(_cfg(telemetry=got)) == hash(_cfg(telemetry=got))


def test_flconfig_takes_only_a_telemetry_config():
    with pytest.raises(TypeError, match="telemetry"):
        _cfg(telemetry="yes")
    with pytest.raises(TypeError, match="telemetry"):
        _jcfg(telemetry="yes")
    assert _cfg().telemetry is None


# ======================================================================
# Ledger: writer and readers across the two packages
# ======================================================================
def _write_ledger(pkg, path):
    if pkg == "reference":
        ledger, sel = jtele.RoundLedger, np.eye(3, dtype=np.float32)
        taps = {"div_mean": np.arange(3, dtype=np.float32),
                "sel_count": np.ones(3, np.float32)}
    else:
        ledger, sel = ttele.RoundLedger, torch.eye(3)
        taps = {"div_mean": torch.arange(3, dtype=torch.float32),
                "sel_count": torch.ones(3)}
    with ledger(path, meta={"run_id": "x", "units": ["a", "b", "c"]}) as led:
        led.round(0, 1.5, {"uplink_total": 1.0, "fedavg_uplink": 2.0}, 1.0,
                  taps=taps, selection=sel, wall_s=0.25, mem_peak_bytes=7)
        led.eval(0, 0.5, 1.0)
    with open(path, "a") as f:
        f.write("{torn json\n")
        f.write(json.dumps({"schema": ttele.LEDGER_SCHEMA + 1,
                            "kind": "round", "round": 9}) + "\n")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ledger_reads_the_same_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "l.jsonl")
    _write_ledger(writer, path)
    got, want = ttele.read_ledger(path), jtele.read_ledger(path)
    assert got == want
    assert [r["kind"] for r in got] == ["run", "round", "eval"]
    assert ttele.split_runs(got) == jtele.split_runs(want)
    assert got[1]["selection"] == np.eye(3, dtype=int).tolist()
    assert got[1]["taps"]["div_mean"] == [0.0, 1.0, 2.0]
    assert ttele.LEDGER_SCHEMA == jtele.LEDGER_SCHEMA == 1


def test_ledger_splits_headerless_records_as_the_reference():
    recs = [{"kind": "round", "round": 0}, {"kind": "eval", "round": 0},
            {"kind": "run", "run_id": "b"}, {"kind": "round", "round": 1}]
    assert ttele.split_runs(recs) == jtele.split_runs(recs)
    assert ttele.split_runs(recs)[0]["meta"] is None


@pytest.mark.parametrize("value,want", [
    (torch.tensor([1.5, -2.0], dtype=torch.bfloat16), [1.5, -2.0]),
    (torch.tensor(3.25), 3.25),
    (torch.tensor([[1, 0], [0, 1]], dtype=torch.int32), [[1, 0], [0, 1]]),
    ({"a": torch.zeros(2), "b": {"c": np.float32(0.5)}},
     {"a": [0.0, 0.0], "b": {"c": 0.5}}),
    (None, None)])
def test_jsonable_takes_tensors(value, want):
    got = _jsonable(value)
    assert got == want and json.loads(json.dumps(got)) == want
    if isinstance(value, torch.Tensor) and not value.is_floating_point():
        assert all(isinstance(x, int) for row in got for x in row)


# ======================================================================
# Progress sink
# ======================================================================
@pytest.mark.parametrize("mode", ["quiet", "human", "structured"])
@pytest.mark.parametrize("call", [
    dict(t=7, loss=0.5, test_error=0.25, uplink_bytes=2e6),
    dict(t=7, loss=0.5), dict(t=1234, loss=2.123456, test_error=0.0,
                              uplink_bytes=123456789.0)])
def test_sink_output_is_the_references(mode, call):
    got, want = io.StringIO(), io.StringIO()
    ttele.ProgressSink(mode, stream=got).round(**call)
    jtele.ProgressSink(mode, stream=want).round(**call)
    assert got.getvalue() == want.getvalue()
    assert ttele.ProgressSink(mode).enabled == (mode != "quiet")


@pytest.mark.parametrize("verbosity", [None, "auto", "quiet", "human",
                                       "structured"])
@pytest.mark.parametrize("verbose", [False, True])
def test_sink_mode_resolution_matches_reference(verbosity, verbose):
    got = ttele.ProgressSink.for_run(
        None if verbosity is None else TelemetryConfig(verbosity=verbosity),
        verbose)
    want = jtele.ProgressSink.for_run(
        None if verbosity is None else JTele(verbosity=verbosity), verbose)
    assert got.mode == want.mode


# ======================================================================
# The taps hook and collect, on the same numpy inputs
# ======================================================================
def _hook_inputs(case, rng):
    u = 5
    sel = (rng.random((K, u)) < 0.5).astype(np.float32)
    divs = rng.random((K, u)).astype(np.float32) * 10.0
    state, extra = None, None
    if case in ("global", "client"):
        state = {"global": {
            "small": rng.standard_normal(u).astype(np.float32),
            "edge": rng.standard_normal(256).astype(np.float32),
            "big": rng.standard_normal(257).astype(np.float32),
            "mat": rng.standard_normal((3, 4)).astype(np.float32),
            "multi": {"a": rng.standard_normal(2).astype(np.float32),
                      "b": rng.standard_normal(3).astype(np.float32)}}}
    if case == "client":
        state["client"] = {"residual": {
            "w": rng.standard_normal((K, 7, 3)).astype(np.float32),
            "b": rng.standard_normal((K, 3)).astype(np.float32)}}
    if case == "extra":
        extra = {"wire_unit_bytes": np.full(u, 104.0, np.float32),
                 "wire_bits": np.full(u, 8.0, np.float32)}
    return sel, (None if case == "no_divs" else divs), state, extra


@pytest.mark.parametrize("case", ["divs", "no_divs", "global", "client",
                                  "extra"])
def test_taps_hook_and_collect_match_reference(case):
    sel, divs, state, extra = _hook_inputs(case, np.random.default_rng(3))

    def to_t(tree):
        return None if tree is None else params_from_numpy(tree, "cpu")

    def to_j(tree):
        return None if tree is None else jax.tree.map(jnp.asarray, tree)

    got = ttaps.collect(make_strategy(_cfg()), to_t(state),
                        torch.from_numpy(sel), to_t(divs), None,
                        extra=to_t(extra))
    want = jtaps.collect(jmake_strategy(_jcfg()), to_j(state),
                         jnp.asarray(sel), to_j(divs), None,
                         extra=to_j(extra))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=HOOK_RTOL,
                                   atol=0, err_msg=name)
    if case == "client":
        assert {"state_small", "state_edge", "state_big_norm",
                "state_mat_norm", "state_multi_norm",
                "state_residual_norm"} <= set(got)


def test_compressed_strategy_taps_delegate_to_inner():
    sel, divs, _, _ = _hook_inputs("divs", np.random.default_rng(4))
    outer, inner = make_strategy(_cfg("int8_ef")), make_strategy(_cfg())
    a = outer.telemetry_taps(None, torch.from_numpy(sel),
                             torch.from_numpy(divs), None)
    b = inner.telemetry_taps(None, torch.from_numpy(sel),
                             torch.from_numpy(divs), None)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_metrics_tap_keys_follow_config(task, mode):
    _, tp, _, _ = task
    batch = {"images": torch.zeros(K, 8, 32, 32, 3),
             "labels": torch.zeros(K, 8, dtype=torch.int64)}
    umap = UnitMap.build(tp)
    _, m = build_round_fn(_tloss, umap, _cfg(mode=mode))(
        tp, batch, torch.ones(K))
    assert "taps" not in m
    _, m = build_round_fn(_tloss, umap, _cfg(
        mode=mode, telemetry=TelemetryConfig()))(tp, batch, torch.ones(K))
    assert sorted(m["taps"]) == ["div_max", "div_mean", "sel_count"]
    assert m["taps"]["div_mean"].shape == (umap.num_units,)


# ======================================================================
# The host driver's ledger against the reference's
# ======================================================================
_LEDGERS = {}


@pytest.fixture
def ledgers(task, tmp_path_factory):
    """case -> (reference ledger, port ledger) of 3 rounds of
    run_training(sampler="host") with an eval after rounds 0 and 2."""
    jp, tp, jd, td = task

    def get(case):
        if case not in _LEDGERS:
            d = tmp_path_factory.mktemp(case)
            jl, tl = str(d / "ref.jsonl"), str(d / "port.jsonl")
            jrun(jp, _jloss, jd, _jcfg(case, telemetry=JTele(
                ledger_path=jl, run_id=case)), rounds=3, seed=0,
                sampler="host", eval_fn=lambda p: 0.5, eval_every=2)
            run_training(tp, _tloss, td, _cfg(case, telemetry=TelemetryConfig(
                ledger_path=tl, run_id=case)), rounds=3, seed=0,
                sampler="host", eval_fn=lambda p: 0.5, eval_every=2,
                device="cpu")
            _LEDGERS[case] = (jl, tl)
        return _LEDGERS[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_host_ledger_matches_reference(ledgers, case):
    jl, tl = ledgers(case)
    (want,), (got,) = _segments(jl), _segments(tl)
    gm, wm = dict(got["meta"]), dict(want["meta"])
    assert sorted(gm) == sorted(wm)
    for meta in (gm, wm):
        del meta["time_unix"]
    assert gm == wm
    assert len(got["rounds"]) == len(want["rounds"]) == 3
    for g, w in zip(got["rounds"], want["rounds"]):
        assert sorted(g) == sorted(w)
        assert g["round"] == w["round"]
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL
        # the byte counts equal, as tests/test_torch_round.py holds them;
        # savings_frac = 1 - uplink/fedavg is an f32 quotient that XLA
        # rounds in its own way: within one f32 ulp of 1.0
        assert sorted(g["comm"]) == sorted(w["comm"])
        for name, value in w["comm"].items():
            tol = 2.0 ** -23 if name == "savings_frac" else 0.0
            assert abs(g["comm"][name] - value) <= tol, name
        assert g["uplink_cum_bytes"] == w["uplink_cum_bytes"]
        assert g["selection"] == w["selection"]
        assert sorted(g["taps"]) == sorted(w["taps"])
        for name in w["taps"]:
            np.testing.assert_allclose(g["taps"][name], w["taps"][name],
                                       rtol=TAP_RTOL, atol=0, err_msg=name)
        assert g["wall_s"] > 0 and w["wall_s"] > 0
        assert g["mem_peak_bytes"] is None     # no device memory on the CPU
    assert got["evals"] == want["evals"]


# ======================================================================
# Zero-cost path, driver schemas, resume
# ======================================================================
DRIVERS = {
    "host_vmap": dict(runner="host", mode="vmap"),
    "host_scan": dict(runner="host", mode="scan"),
    "engine": dict(runner="engine", mode="vmap"),
    "engine_int8_ef": dict(runner="engine", mode="vmap", case="int8_ef"),
}


def _drive(task, runner, mode, tele, case="fedldf", rounds=4, **kw):
    _, tp, _, td = task
    fl = _cfg(case, mode=mode, telemetry=tele)
    if runner == "host":
        return run_training(tp, _tloss, td, fl, rounds=rounds, seed=0,
                            sampler="device", device="cpu", **kw)
    return run_training_scan(tp, _tloss, td, fl, rounds=rounds, seed=0,
                             device="cpu", **kw)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_telemetry_on_is_bit_identical_to_off(task, tmp_path, driver):
    tele = TelemetryConfig(ledger_path=str(tmp_path / "l.jsonl"),
                           profile_rounds=(1, 2),
                           profile_dir=str(tmp_path / "trace"))
    kw = dict(eval_fn=lambda p: 0.5, eval_every=2)
    p0, l0 = _drive(task, tele=None, **DRIVERS[driver], **kw)
    p1, l1 = _drive(task, tele=tele, **DRIVERS[driver], **kw)
    _assert_same_params(p0, p1)
    assert l0.losses == l1.losses and l0.uplink_mb == l1.uplink_mb
    assert l0.meter == l1.meter and l0.test_errors == l1.test_errors
    if l0.final_state is not None:
        for a, b in zip(tree_leaves(l0.final_state),
                        tree_leaves(l1.final_state)):
            assert torch.equal(a, b)
    assert len(_segments(tele.ledger_path)[0]["rounds"]) == 4


@pytest.mark.parametrize("case", ["fedldf", "int8_ef"])
def test_both_drivers_write_the_same_ledger(task, tmp_path, case):
    """run_training(sampler="device") and the engine give the same rounds,
    so their ledgers agree record for record (but the wall clock)."""
    segs = {}
    for runner in ("host", "engine"):
        lp = str(tmp_path / f"{runner}.jsonl")
        _drive(task, runner, "vmap", TelemetryConfig(ledger_path=lp), case,
               rounds=5, eval_fn=lambda p: 0.5, eval_every=2)
        segs[runner] = _segments(lp)[0]
    h, e = segs["host"], segs["engine"]
    assert sorted(h["meta"]) == sorted(e["meta"])
    assert (h["meta"]["driver"], e["meta"]["driver"]) == ("host", "scan")
    assert h["meta"]["sampler"] == e["meta"]["sampler"] == "device"
    assert [r["round"] for r in h["rounds"]] == \
        [r["round"] for r in e["rounds"]] == list(range(5))
    for a, b in zip(h["rounds"], e["rounds"]):
        assert sorted(a) == sorted(b)
        for key in ("loss", "comm", "uplink_cum_bytes", "taps", "selection"):
            assert a[key] == b[key], key
    assert [v["round"] for v in h["evals"]] == \
        [v["round"] for v in e["evals"]] == [0, 2, 4]
    assert h["evals"] == e["evals"]


@pytest.mark.parametrize("case", ["fedlama", "fedavg"])
@pytest.mark.parametrize("runner", ["host", "engine"])
def test_resumed_ledger_is_contiguous(task, tmp_path, case, runner):
    """save -> load -> continue appends a ledger whose rounds are those of
    an uninterrupted run, gap-free, with the same losses."""
    full = str(tmp_path / "full.jsonl")
    pf, _ = _drive(task, runner, "vmap", TelemetryConfig(ledger_path=full),
                   case, rounds=6)
    res = str(tmp_path / "resumed.jsonl")
    tele = TelemetryConfig(ledger_path=res)
    p1, log1 = _drive(task, runner, "vmap", tele, case, rounds=3)
    ckpt = str(tmp_path / "server.npz")
    save_server_state(ckpt, p1, log1.final_state)
    p_loaded, state = load_server_state(ckpt, "cpu")
    _, tp, _, td = task
    fl = _cfg(case, telemetry=tele)
    if runner == "host":
        p2, _ = run_training(p_loaded, _tloss, td, fl, rounds=3, seed=0,
                             sampler="device", start_round=3,
                             server_state=state, device="cpu")
    else:
        p2, _ = run_training_scan(p_loaded, _tloss, td, fl, rounds=3, seed=0,
                                  start_round=3, server_state=state,
                                  device="cpu")
    _assert_same_params(pf, p2)
    (whole,), parts = _segments(full), _segments(res)
    assert len(parts) == 2 and parts[1]["meta"]["start_round"] == 3
    assert [r["round"] for s in parts for r in s["rounds"]] == \
        [r["round"] for r in whole["rounds"]] == list(range(6))
    assert [r["loss"] for s in parts for r in s["rounds"]] == \
        [r["loss"] for r in whole["rounds"]]


@pytest.mark.parametrize("case,tap", [("fedlama", "state_interval"),
                                      ("fedlama", "state_ttl"),
                                      ("int8_ef", "state_residual_norm")])
def test_block_taps_are_each_rounds_own(task, case, tap):
    """A 4-round block's stacked taps equal those of 4 one-round blocks
    (no tap aliases a buffer a later round writes), and FedLAMA's state
    taps equal the state each round leaves."""
    _, tp, _, td = task
    fl = _cfg(case, telemetry=TelemetryConfig())
    shards = ClientShards.from_federated(td)
    sizes, host_sizes = shards.data_sizes(), shards.part_sizes.cpu()
    run_block = tserver._build_block_fn(_tloss, UnitMap.build(tp), fl)

    def fresh():
        return (tp, make_strategy(fl).init_state(tp, N), comm_acc_init("cpu"))

    draws = KeyedDraws(0)
    _, block = run_block(fresh(), shards, sizes, host_sizes, draws, 0, 4)
    carry, one, states = fresh(), [], []
    for t in range(4):
        carry, per = run_block(carry, shards, sizes, host_sizes, draws, t, 1)
        one.append(per["taps"][tap][0])
        if case == "fedlama":
            states.append(carry[1]["global"][tap[len("state_"):]])
    assert block["taps"][tap].shape[0] == 4
    for t in range(4):
        assert torch.equal(block["taps"][tap][t], one[t])
        if states:
            assert torch.equal(block["taps"][tap][t], states[t])
    host, copies = tserver._pull(block)
    assert copies == 1 and torch.equal(host["taps"][tap], block["taps"][tap])


def test_pull_makes_one_copy_a_dtype():
    tree = {"a": torch.arange(6.0).view(2, 3), "b": {"c": torch.ones(2),
                                                     "d": torch.arange(4)}}
    host, copies = tserver._pull(tree)
    assert copies == 2
    for x, y in zip(tree_leaves(host), tree_leaves(tree)):
        assert torch.equal(x, y) and x.dtype == y.dtype


# ======================================================================
# Verbose output, program spans, profile window
# ======================================================================
def _legacy_lines(log, runner, rounds, with_eval):
    """The lines verbose=True printed before the sink existed."""
    lines = []
    if with_eval:
        for t, err, up in log.test_errors:
            loss = log.losses[log.rounds.index(t)]
            lines.append(f"round {t:4d} loss {loss:.4f} test_err {err:.4f} "
                         f"uplink {up / 1e6:.1f}MB")
    elif runner == "host":
        lines = [f"round {t:4d} loss {log.losses[t]:.4f}"
                 for t in range(rounds) if t % 10 == 0]
    else:
        lines = [f"round {rounds - 1:4d} loss {log.losses[-1]:.4f}"]
    return lines


@pytest.mark.parametrize("tele", [None, "auto"])
@pytest.mark.parametrize("with_eval", [True, False])
@pytest.mark.parametrize("runner", ["host", "engine"])
def test_verbose_output_is_unchanged(task, capsys, runner, with_eval, tele):
    rounds = 3 if with_eval else 11
    kw = dict(eval_fn=lambda p: 0.25, eval_every=2) if with_eval else {}
    _, log = _drive(task, runner, "vmap",
                    None if tele is None else TelemetryConfig(),
                    rounds=rounds, verbose=True, **kw)
    out = capsys.readouterr().out.splitlines()
    assert out == _legacy_lines(log, runner, rounds, with_eval)


def test_span_off_is_the_shared_no_op_and_records_nothing():
    a, b = tprof.span("engine.round"), tprof.span("round.select")
    assert a is b
    with a, b:
        pass
    with tprof.recording() as spans:
        with a:          # made while off: stays the no-op
            pass
    assert spans == []


def test_spans_nest_per_thread_on_the_wall_clock():
    worker_tid = []

    def worker():
        with tprof.span("attention.bwd"):
            worker_tid.append(threading.get_ident())

    thread = threading.Thread(target=worker)
    with tprof.recording() as spans:
        before = time.time_ns()
        with tprof.span("local_update"):
            with tprof.span("forward"):
                pass
            thread.start()
            thread.join(timeout=30)
            with tprof.span("sgd"):
                pass
        after = time.time_ns()
    assert not thread.is_alive()
    main = threading.get_ident()
    assert [(path, tid) for path, _, _, tid in spans] == [
        ("local_update/forward", main), ("attention.bwd", worker_tid[0]),
        ("local_update/sgd", main), ("local_update", main)]
    at = {path: (s, e) for path, s, e, _ in spans}
    assert before <= at["local_update"][0] <= at["local_update/forward"][0]
    assert at["local_update/forward"][1] <= at["attention.bwd"][0]
    assert at["attention.bwd"][1] <= at["local_update/sgd"][0]
    assert at["local_update/sgd"][1] <= at["local_update"][1] <= after
    with tprof.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with tprof.recording():
                pass


_LOCAL = ["local_update", "local_update/forward", "local_update/sgd"]


def _round_tree(mode, case):
    """The spans one round emits, as paths under the round's parent."""
    if mode == "vmap":
        paths = (["round.local_training"]
                 + [f"round.local_training/{p}" for p in _LOCAL]
                 + ["round.divergence", "round.select"])
        if case == "int8_ef":
            paths += ["round.state_view", "round.uplink",
                      "round.update_state", "round.state_scatter"]
        else:
            paths += ["round.aggregate"]
    else:
        paths = ["round.phase1", "round.select", "round.phase2",
                 "round.finalize"]
        paths += K * ([f"round.phase1/{p}" for p in _LOCAL]
                      + ["round.phase1/round.divergence"]
                      + [f"round.phase2/{p}" for p in _LOCAL]
                      + ["round.phase2/round.aggregate"])
    return collections.Counter(paths)


@pytest.mark.parametrize("runner,mode,case", [
    ("engine", "vmap", "fedldf"), ("engine", "scan", "fedldf"),
    ("engine", "vmap", "int8_ef"), ("host", "vmap", "fedldf")])
def test_engine_and_host_loop_emit_the_documented_span_tree(task, runner,
                                                           mode, case):
    """3 rounds in two blocks (an evaluation after rounds 0 and 2): the
    engine's spans once a call, once a block and once a round; the host
    loop (``run_training``) shares the round's through ``_step``."""
    with tprof.recording() as spans:
        _drive(task, runner, mode, None, case, rounds=3,
               eval_fn=lambda p: 0.5, eval_every=2)
    assert {tid for *_, tid in spans} == {threading.get_ident()}
    rounds = collections.Counter()
    for _ in range(3):
        rounds.update(_round_tree(mode, case))
    if runner == "host":
        want = rounds
    else:
        want = collections.Counter(
            {"engine.enter": 1, "engine.exit": 1, "engine.draws": 2,
             "engine.pull": 2, "engine.round": 3})
        want.update({f"engine.round/{p}": n for p, n in rounds.items()})
    assert collections.Counter(path for path, *_ in spans) == want
    for _, s, e, _ in spans:
        assert s <= e


@pytest.mark.parametrize("how", [
    dict(runner="host", mode="vmap"), dict(runner="host", mode="scan"),
    dict(runner="engine", mode="vmap"),
    dict(runner="engine", mode="vmap", case="int8_ef"),
    dict(runner="engine", mode="scan")],
    ids=["host_vmap", "host_scan", "engine", "engine_int8_ef", "engine_scan"])
def test_recording_spans_is_bit_identical_to_not(task, how):
    kw = dict(eval_fn=lambda p: 0.5, eval_every=2)
    p0, l0 = _drive(task, tele=None, **how, **kw)
    with tprof.recording() as spans:
        p1, l1 = _drive(task, tele=None, **how, **kw)
    assert spans
    _assert_same_params(p0, p1)
    assert l0.losses == l1.losses and l0.uplink_mb == l1.uplink_mb
    assert l0.meter == l1.meter and l0.test_errors == l1.test_errors
    if l0.final_state is not None:
        for a, b in zip(tree_leaves(l0.final_state),
                        tree_leaves(l1.final_state)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("runner,window,want", [
    ("host", (1, 2), "rounds_1-2.json"),
    ("engine", (1, 2), "rounds_1-2.json"),    # block [1, 3)
    ("engine", (2, 3), "rounds_1-3.json"),    # blocks [1, 3) and [3, 4)
    ("engine", (0, 0), "rounds_0-0.json")])
def test_profile_window_writes_one_trace(task, tmp_path, runner, window,
                                         want):
    d = tmp_path / "trace"
    _drive(task, runner, "vmap", TelemetryConfig(
        profile_rounds=window, profile_dir=str(d)), rounds=4,
        eval_fn=lambda p: 0.5, eval_every=2)
    assert os.listdir(d) == [want]
    with open(d / want) as f:
        assert json.load(f)["traceEvents"]


def _window_events(cls, window, blocks):
    """The window's open/closed state after each call, with start/stop
    replaced by flag flips (the decisions alone)."""
    w = cls(window, "")

    def start(*a):
        w.active, w._span = True, [0, 0]

    def stop():
        w.active = False

    w._start, w._stop = start, stop
    seen = []
    if blocks is None:                          # the host driver
        for t in range(8):
            w.round_begin(t)
            seen.append(w.active)
            w.round_end(t)
            seen.append(w.active)
    else:
        t0 = 0
        for t1 in blocks:
            w.block_begin(t0, t1)
            seen.append(w.active)
            w.block_end(t1)
            seen.append(w.active)
            t0 = t1
    w.close()
    return seen + [w.active]


@pytest.mark.parametrize("window", [None, (0, 0), (1, 2), (2, 3), (3, 3),
                                    (0, 7), (5, 20), (9, 12)])
@pytest.mark.parametrize("blocks", [None, [1, 3, 4], [1, 3, 5, 7, 8], [8]],
                         ids=["host", "eval2x4", "eval2x8", "one-block"])
def test_profile_window_decisions_match_reference(window, blocks):
    assert _window_events(tprof.ProfileWindow, window, blocks) == \
        _window_events(jprof.ProfileWindow, window, blocks)


def test_profile_window_defaults_to_the_card_and_traces_the_cpu(tmp_path):
    """The window's device defaults to ``cuda`` like every entry point; a
    window given ``device="cpu"`` records the host's ops and writes its
    trace of the rounds it covers."""
    assert tprof.ProfileWindow((0, 0), str(tmp_path)).device.type == "cuda"
    assert tprof.ProfileWindow.from_config(
        TelemetryConfig()).device.type == "cuda"
    win = tprof.ProfileWindow((1, 1), str(tmp_path), device="cpu")
    for t in range(3):
        win.round_begin(t)
        torch.ones(64).cumsum(0).sum()
        win.round_end(t)
    win.close()
    assert os.listdir(tmp_path) == ["rounds_1-1.json"]
    with open(tmp_path / "rounds_1-1.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_device_memory_peak_is_none_on_the_cpu():
    assert tprof.device_memory_peak("cpu") is None


# ======================================================================
# Monitor
# ======================================================================
@pytest.mark.parametrize("case", ["fedlama", "int8_ef"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_monitor_text_is_the_references(ledgers, case, writer):
    path = ledgers(case)[0 if writer == "reference" else 1]
    got, want = io.StringIO(), io.StringIO()
    assert monitor.render(path, out=got, bins=40) == \
        jmonitor.render(path, out=want, bins=40) == 1
    assert got.getvalue() == want.getvalue()
    assert "per-layer mean divergence" in got.getvalue()
    assert "per-layer uploads" in got.getvalue()


@pytest.mark.parametrize("series,bins", [
    ([], 10), ([1.0], 10), ([np.nan, 1.0, 2.0], 10), ([3.0, 3.0, 3.0], 10),
    (list(range(100)), 10), ([np.inf, -1.0, 5.0, np.nan], 2)])
def test_monitor_helpers_match_reference(series, bins):
    assert monitor.sparkline(series) == jmonitor.sparkline(series)
    np.testing.assert_array_equal(monitor.bin_series(series, bins),
                                  jmonitor.bin_series(series, bins))


def test_monitor_reports_an_empty_ledger_as_the_reference(tmp_path):
    path = str(tmp_path / "empty.jsonl")
    open(path, "w").close()
    got, want = io.StringIO(), io.StringIO()
    assert monitor.render(path, out=got) == jmonitor.render(path, out=want)
    assert got.getvalue() == want.getvalue()


# ======================================================================
# CommMeter.summary, vgg9(), vgg9_fl(), the launcher
# ======================================================================
def test_comm_summary_matches_reference():
    kw = dict(uplink_bytes=75_356_016.0, downlink_bytes=376_776_480.0,
              fedavg_uplink_bytes=376_776_480.0, rounds=1)
    assert tcomm.CommMeter(**kw).summary() == jcomm.CommMeter(**kw).summary()
    assert tcomm.CommMeter().summary() == jcomm.CommMeter().summary()


@pytest.mark.parametrize("algo", ["fedldf", "fedavg", "fedadp", "fedlama"])
def test_vgg9_configs_match_reference(algo):
    assert dataclasses.asdict(tconfigs.vgg9()) == \
        dataclasses.asdict(jconfigs.vgg9())
    got, want = tconfigs.vgg9_fl(algo), jconfigs.vgg9_fl(algo)
    for f in ("algo", "num_clients", "clients_per_round", "top_n",
              "local_steps", "lr", "mode", "batch_per_client",
              "fedadp_keep", "fedlp_p", "fedlama_tau", "fedlama_lam",
              "quantize_bits", "error_feedback", "compression",
              "telemetry"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("argv", [
    ["--task", "cifar", "--rounds", "2", "--eval-every", "1"],
    ["--task", "lm", "--reduced", "--rounds", "1"]], ids=["cifar", "lm"])
def test_launcher_runs_on_the_cpu(capsys, argv):
    ttrain.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    summary = ast.literal_eval(out[-1][len("comm summary: "):])
    assert out[-1].startswith("comm summary: ")
    assert sorted(summary) == sorted(jcomm.CommMeter().summary())
    rounds = int(argv[argv.index("--rounds") + 1])
    assert summary["rounds"] == rounds
    assert out[0].startswith("round    0 loss ")
    if argv[1] == "cifar":
        # fedldf: n·model + K·U·4 a round (reduced VGG-9, K=10, n=2)
        from repro_torch.models import cnn
        umap = UnitMap.build(cnn.init_params(
            cnn.VGGConfig().reduced(), torch.Generator().manual_seed(0),
            "cpu"))
        per = 2 * umap.total_bytes + 10 * umap.num_units * 4
        assert summary["uplink_MB"] == rounds * per / 1e6
        assert len(out) == rounds + 1 and "test_err" in out[0]
