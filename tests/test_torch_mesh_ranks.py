"""The port's client mesh in spawned worlds of 2 and 4 gloo ranks on the
CPU (``repro_torch.launch.mesh.spawn``), against the reference: the
quickstart's reduced VGG-9 at N=8, K=4, n=2, B=8.

One spawn a world size runs every check of that world
(``tests/torch_mesh_worker.py:world``; the children import ``repro_torch``
only, and the reference's ``round_keys`` draws reach them as numpy
arrays); the tests below read its results:

- the mesh run against the reference's unsharded run on the same draws,
  within the reference's own sharded-vs-unsharded tolerance
  (``tests/test_shard_engine.py:25``, 2e-5; losses 1e-5), in fedldf,
  setting A (int8 + EF; plus one quantization step, as
  ``tests/test_torch_compressed_round.py``) and FedADP, with the comm
  bytes exact;
- two-tier against flat, ``hierarchical_psum`` (and the tier-1 reduce
  over the whole clients axis) against a flat all-reduce, the
  collectives a round, every rank's params and EF store bit for bit;
- host driver against engine and telemetry on against off, bit for bit,
  and the ledger's mesh header and tier bytes;
- sample sharding against the replicated placement, bit for bit;
- a submesh of world ranks 0-1 in the world of 4 (``make_client_mesh(2)``
  and the 1 x 2 grid): the 2-rank world's round bit for bit, and the
  reference's ``make_client_mesh(2)`` round, run on 2 forced CPU devices
  in a subprocess, within 2e-5; ranks 2-3 raise.

The reference's one-device mesh round covers D=1 in this process; its
D=2/4 sharded rounds run only when ``REPRO_TEST_DEVICES`` gives JAX the
devices (as ``tests/test_shard_engine.py``).
"""
import io
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data as jdata  # noqa: E402
from repro.core import agg_tier_bytes as jtier  # noqa: E402
from repro.core.wire import CompressionConfig as JComp  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import run_training_scan as jscan  # noqa: E402
from repro.federated import sampling as jsampling  # noqa: E402
from repro.launch.mesh import make_client_mesh as jmesh  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import torch_mesh_worker as w  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.data import FederatedData  # noqa: E402
from repro_torch.federated import run_training, run_training_scan  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import monitor  # noqa: E402
from repro_torch.telemetry import read_ledger, split_runs  # noqa: E402

PARAM_TOL = 2e-5   # tests/test_shard_engine.py:25 (EQUIV_TOL)
LOSS_TOL = 1e-5    # tests/test_round_engine.py:61
WORLDS = (2, 4)
ROUNDS = 3


def _jcfg(mesh=None, algo="fedldf", **kw):
    return JFLConfig(algo=algo, num_clients=w.N, clients_per_round=w.K,
                     top_n=w.TOP_N, mode="vmap", batch_per_client=w.B,
                     mesh=mesh, **kw)


def _jloss(p, b):
    return jcnn.classify_loss(p, jcnn.VGGConfig().reduced(), b)


@pytest.fixture(scope="module")
def task():
    """The data, the reference's params and its draws for ROUNDS rounds
    (``round_keys(PRNGKey(0), t)``, drawn as its engine draws them)."""
    train, _ = jdata.make_image_dataset(num_train=320, num_test=16, seed=2)
    parts = jdata.iid_partition(train.ys, w.N, seed=0)
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcnn.VGGConfig().reduced())
    sizes = np.asarray([len(p_) for p_ in parts], np.int32)
    draws, base = {}, jax.random.PRNGKey(0)
    for t in range(ROUNDS):
        ck, bk, ak = jsampling.round_keys(base, t)
        c = np.asarray(jsampling.sample_clients_grouped(ck, w.N, w.K, 1))
        j = jax.random.randint(bk, (w.K, w.B), 0,
                               jnp.asarray(sizes[c])[:, None])
        draws[t] = {"clients": c.astype(np.int64),
                    "indices": np.asarray(j).astype(np.int64),
                    "uniform": np.array(jax.random.uniform(
                        ak, (w.K, len(jp))))}
    return {"params": jax.tree.map(np.asarray, jp), "xs": train.xs,
            "ys": train.ys, "parts": parts, "draws": draws, "jp": jp,
            "jd": jdata.FederatedData(train.xs, train.ys, parts)}


# the reference's make_client_mesh(2) round on the task, in a process of
# its own: JAX's device count is fixed when it starts
_SUBMESH_REF = """
import sys
import jax
import numpy as np
import repro.data as jdata
from repro.federated import FLConfig, run_training_scan
from repro.launch.mesh import make_client_mesh
from repro.models import cnn
cfg = cnn.VGGConfig().reduced()
train, _ = jdata.make_image_dataset(num_train=320, num_test=16, seed=2)
data = jdata.FederatedData(train.xs, train.ys,
                           jdata.iid_partition(train.ys, {n}, seed=0))
fl = FLConfig(algo="fedldf", num_clients={n}, clients_per_round={k},
              top_n={top}, mode="vmap", batch_per_client={b},
              mesh=make_client_mesh(2))
p, log = run_training_scan(cnn.init_params(jax.random.PRNGKey(0), cfg),
                           lambda p, b: cnn.classify_loss(p, cfg, b), data,
                           fl, rounds={rounds}, seed=0)
np.savez(sys.argv[1], *[np.asarray(l) for l in jax.tree.leaves(p)],
         losses=np.asarray(log.losses),
         uplink=np.asarray(float(log.meter.uplink_bytes)))
""".format(n=w.N, k=w.K, top=w.TOP_N, b=w.B, rounds=ROUNDS)


def _reference_submesh_round(path):
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": src,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    subprocess.run([sys.executable, "-c", _SUBMESH_REF, str(path)],
                   env=env, check=True, timeout=600)
    with np.load(path) as z:
        n = len([f for f in z.files if f.startswith("arr_")])
        return {"leaves": [z[f"arr_{i}"] for i in range(n)],
                "losses": z["losses"], "uplink": float(z["uplink"])}


@pytest.fixture(scope="module")
def runs(task, tmp_path_factory):
    """Each world's per-rank results (one spawn a world size, both worlds
    started together) and, computed meanwhile, the reference's unsharded
    runs on the same draws (fedldf, setting A, FedADP)."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = {}
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        sub = pool.submit(_reference_submesh_round,
                          tmp_path_factory.mktemp("sub") / "ref.npz")
        for d in WORLDS:
            tmp = tmp_path_factory.mktemp(f"world{d}")
            job = {k_: task[k_] for k_ in ("params", "xs", "ys", "parts",
                                           "draws")}
            job.update(device="cpu", ledger=str(tmp / "ledger.jsonl"))
            jobs[d] = (pool.submit(tmesh.spawn, w.world, d, (job,),
                                   store_dir=str(tmp)), job["ledger"])
        jp, jd = task["jp"], task["jd"]
        ref = {
            "flat": jscan(jp, _jloss, jd, _jcfg(), rounds=ROUNDS, seed=0),
            "A": jscan(jp, _jloss, jd, _jcfg(compression=JComp(
                bits=8, error_feedback=True)), rounds=ROUNDS, seed=0),
            "fedadp": jscan(jp, _jloss, jd, _jcfg(algo="fedadp"), rounds=2,
                            seed=0),
        }
        worlds = {d: {"ranks": fut.result(), "ledger": ledger}
                  for d, (fut, ledger) in jobs.items()}
        ref["sub2"] = sub.result()
    return {"ref": ref, "worlds": worlds}


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.fixture(scope="module")
def ref(task, runs):
    return {**task, "runs": runs["ref"]}


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(_leaves(a), _leaves(b)))


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _near_reference(run, jparams, jlog, step_rule=False):
    np.testing.assert_allclose(run["losses"], jlog.losses, atol=LOSS_TOL,
                               rtol=0)
    assert run["uplink"] == float(jlog.meter.uplink_bytes)
    if not step_rule:
        assert _max_diff(run["params"], jparams) <= PARAM_TOL
        return
    jn = jax.tree.map(np.asarray, jparams)
    for key in jn:
        step = max(float(np.abs(v).max())
                   for v in jax.tree.leaves(jn[key])) / 127.0
        assert _max_diff(run["params"][key], jn[key]) <= PARAM_TOL + step


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("kind", ["flat", "tier"])
def test_mesh_matches_reference_unsharded(worlds, ref, d, kind):
    jparams, jlog = ref["runs"]["flat"]
    _near_reference(worlds[d]["ranks"][0][kind], jparams, jlog)


@pytest.mark.parametrize("d", WORLDS)
def test_setting_a_on_the_mesh_matches_reference(worlds, ref, d):
    jparams, jlog = ref["runs"]["A"]
    run = worlds[d]["ranks"][0]["A"]
    _near_reference(run, jparams, jlog, step_rule=True)
    jres = jlog.final_state["client"]["residual"]
    assert jax.tree.structure(jax.tree.map(np.asarray, jres)) == \
        jax.tree.structure(run["state"]["client"]["residual"])


@pytest.mark.parametrize("d", WORLDS)
def test_fedadp_on_the_mesh_matches_reference(worlds, ref, d):
    jparams, jlog = ref["runs"]["fedadp"]
    _near_reference(worlds[d]["ranks"][0]["fedadp"], jparams, jlog)


def test_one_rank_mesh_matches_the_references_one_device_mesh(ref):
    """D=1: the port's mesh of this process alone against the reference's
    ``shard_map`` round on ``make_client_mesh(1)``."""
    jparams, jlog = jscan(ref["jp"], _jloss, ref["jd"], _jcfg(jmesh(1)),
                          rounds=2, seed=0)
    m = tmesh.make_client_mesh(1, device="cpu")
    tparams, tlog = run_training_scan(
        params_from_numpy(ref["params"], "cpu"), w.loss_fn,
        FederatedData(ref["xs"], ref["ys"], ref["parts"]),
        w.fl_config(m), rounds=2, seed=0, device="cpu",
        draws=w.ArrayDraws(ref["draws"]))
    run = {"params": params_to_numpy(tparams), "losses": tlog.losses,
           "uplink": tlog.meter.uplink_bytes}
    _near_reference(run, jparams, jlog)
    assert m.counts()["all_reduce_flat"][0] == 2


@pytest.mark.parametrize("d", WORLDS)
def test_mesh_matches_the_references_sharded_round(worlds, ref, d):
    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} JAX devices; set REPRO_TEST_DEVICES=8")
    jparams, jlog = jscan(ref["jp"], _jloss, ref["jd"], _jcfg(jmesh(d)),
                          rounds=ROUNDS, seed=0)
    _near_reference(worlds[d]["ranks"][0]["flat"], jparams, jlog)


# ----------------------------------------------------------------------
# the port against itself
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", WORLDS)
def test_two_tier_matches_flat(worlds, d):
    r0 = worlds[d]["ranks"][0]
    assert _max_diff(r0["tier"]["params"], r0["flat"]["params"]) <= \
        PARAM_TOL
    np.testing.assert_allclose(r0["tier"]["losses"], r0["flat"]["losses"],
                               atol=LOSS_TOL, rtol=0)
    assert r0["tier"]["uplink"] == r0["flat"]["uplink"]


@pytest.mark.parametrize("d", WORLDS)
def test_every_rank_holds_the_same_bits(worlds, d):
    ranks = worlds[d]["ranks"]
    assert [r["rank"] for r in ranks] == list(range(d))
    assert {(r["size"], r["backend"], r["stage"]) for r in ranks} == \
        {(d, "gloo", False)}
    for kind in ("flat", "tier", "A", "fedadp", "engine", "host", "host_np",
                 "tele"):
        for r in ranks[1:]:
            _assert_same(r[kind]["params"], ranks[0][kind]["params"])
            _assert_same(r[kind]["state"], ranks[0][kind]["state"])
            assert r[kind]["losses"] == ranks[0][kind]["losses"]
            assert r[kind]["uplink"] == ranks[0][kind]["uplink"]


@pytest.mark.parametrize("d", WORLDS)
def test_collectives_a_round(worlds, d):
    """One fused all-reduce and one divergence all-gather a fedldf round;
    setting A adds the EF rows' all-gather; the two-tier reduce is one
    group all-reduce (none at group size 1) and G − 1 ring shifts."""
    r0 = worlds[d]["ranks"][0]

    def calls(kind):
        return {op: cb[0] for op, cb in r0[kind]["counts"].items()
                if op != "staged" and cb[0]}

    assert calls("flat") == {"all_reduce_flat": ROUNDS,
                             "all_gather_rows": ROUNDS}
    assert calls("A") == {"all_reduce_flat": ROUNDS,
                          "all_gather_rows": 2 * ROUNDS}
    assert calls("fedadp") == {"all_reduce_flat": 2}
    gs = 1 if d == 2 else 2
    g = d // gs
    want = {"all_gather_rows": ROUNDS, "ring_shift": (g - 1) * ROUNDS}
    if gs > 1:
        want["group_all_reduce"] = ROUNDS
    assert calls("tier") == want
    # the reduce's payload: the (U,)-weighted numerators, the (U,)
    # denominator and the loss sum, f32
    n_params = sum(v.size for v in _leaves(r0["flat"]["params"]))
    n_units = len(r0["flat"]["params"])
    assert r0["flat"]["counts"]["all_reduce_flat"][1] == \
        ROUNDS * 4 * (n_params + n_units + 1)
    # the divergence block: this rank's (K/D, U) f32 rows
    assert r0["flat"]["counts"]["all_gather_rows"][1] == \
        ROUNDS * 4 * (w.K // d) * n_units


@pytest.mark.parametrize("d", WORLDS)
def test_host_driver_equals_engine_and_telemetry_is_free(worlds, d):
    r0 = worlds[d]["ranks"][0]
    for a, b in (("host", "engine"), ("tele", "tele_off")):
        _assert_same(r0[a]["params"], r0[b]["params"])
        _assert_same(r0[a]["state"], r0[b]["state"])
        assert r0[a]["losses"] == r0[b]["losses"]
        assert r0[a]["uplink"] == r0[b]["uplink"]


def test_host_sampler_on_the_mesh_matches_one_device(worlds, ref):
    """The numpy host sampler on a mesh (every rank draws the whole
    cohort, gathers its rows) against the same call off the mesh."""
    tp, tlog = run_training(
        params_from_numpy(ref["params"], "cpu"), w.loss_fn,
        FederatedData(ref["xs"], ref["ys"], ref["parts"]),
        w.fl_config(), rounds=2, seed=5, sampler="host", device="cpu")
    for d in WORLDS:
        run = worlds[d]["ranks"][0]["host_np"]
        assert _max_diff(run["params"], params_to_numpy(tp)) <= PARAM_TOL
        np.testing.assert_allclose(run["losses"], tlog.losses,
                                   atol=LOSS_TOL, rtol=0)
        assert run["uplink"] == tlog.meter.uplink_bytes


@pytest.mark.parametrize("d", WORLDS)
def test_ledger_of_a_mesh_run(worlds, d):
    """Rank 0 alone writes the ledger: the mesh header, the tier bytes of
    the reference's agg_tier_bytes in every round, the EF norm tap from
    the summed partials, the monitor's tier line."""
    path = worlds[d]["ledger"]
    segs = split_runs(read_ledger(path))
    assert [s_["meta"]["run_id"] for s_ in segs] == [f"mesh{d}"]
    meta = segs[0]["meta"]
    gs = 1 if d == 2 else 2
    assert meta["mesh"] == {"clients": d}
    assert meta["agg"] == {"group_size": gs, "num_groups": d // gs,
                           "tiers": 2}
    assert meta["shard_samples"] is False
    payload = 4.0 * sum(v.size for v in _leaves(
        worlds[d]["ranks"][0]["tele"]["params"]))
    want = jtier(payload, d, gs)
    recs = segs[0]["rounds"]
    assert [x["round"] for x in recs] == list(range(ROUNDS))
    for x in recs:
        for key, v in want.items():
            assert x["comm"][key] == v, key
        assert np.isfinite(x["taps"]["state_residual_norm"])
    buf = io.StringIO()
    assert monitor.render(path, out=buf) == 1
    text = buf.getvalue()
    assert f"2-tier agg: {d // gs} groups of {gs}" in text
    assert "agg traffic/round (2-tier reduce)" in text


@pytest.mark.parametrize("d", WORLDS)
def test_hierarchical_psum_equals_a_flat_all_reduce(worlds, d):
    for r in worlds[d]["ranks"]:
        want = r["psum"]["want"]
        for g, got in r["psum"]["got"].items():
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=str(g))
        # every rank holds the same bits for each tier choice
        for g, got in r["psum"]["got"].items():
            np.testing.assert_array_equal(
                got, worlds[d]["ranks"][0]["psum"]["got"][g])


@pytest.mark.parametrize("d", WORLDS)
def test_round_comm_and_aggregate_over_local_rows(worlds, d):
    for r in worlds[d]["ranks"]:
        local, full = r["comm"]
        assert local == full
        assert _max_diff(r["aggregate"][0], r["aggregate"][1]) <= 1e-6


def test_sample_sharding_equals_the_replicated_placement(worlds):
    for r in worlds[2]["ranks"]:
        for kind in ("shard", "shard_host"):
            _assert_same(r[kind]["params"], r["rep_aff"]["params"])
            assert r[kind]["losses"] == r["rep_aff"]["losses"]
            assert r[kind]["uplink"] == r["rep_aff"]["uplink"]
        rep_bytes, shard_bytes = r["bytes"]
        assert shard_bytes <= rep_bytes // 2 + 4 * 3072 * 8
        loader, rep, shd = r["gather"]
        for key in loader:
            np.testing.assert_array_equal(rep[key], loader[key])
            np.testing.assert_array_equal(shd[key], loader[key])


def test_shard_samples_needs_the_device_sampler():
    m = tmesh.make_client_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="sampler='device'"):
        run_training({}, w.loss_fn, None, w.fl_config(m, shard_samples=True),
                     rounds=1, sampler="host", device="cpu")


def test_a_rank_that_raises_fails_the_world(tmp_path):
    import torch.multiprocessing as mp
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        tmesh.spawn(w.raise_on_rank_one, 2, store_dir=str(tmp_path))


# ----------------------------------------------------------------------
# a submesh of the world
# ----------------------------------------------------------------------
def test_submesh_of_two_in_a_world_of_four(worlds, ref):
    """``make_client_mesh(2)`` in every rank of the world of 4: ranks 0-1
    give the 2-rank world's round bit for bit, and the reference's
    ``make_client_mesh(2)`` round within 2e-5."""
    two = worlds[2]["ranks"][0]["flat"]
    want = ref["runs"]["sub2"]
    for r in worlds[4]["ranks"][:2]:
        assert r["sub_shape"] == ({"clients": 2}, True)
        run = r["sub"]
        _assert_same(run["params"], two["params"])
        assert run["losses"] == two["losses"]
        assert run["uplink"] == two["uplink"]
        got = _leaves(run["params"])
        assert len(got) == len(want["leaves"])
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(got, want["leaves"])) <= PARAM_TOL
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   atol=LOSS_TOL, rtol=0)
        assert run["uplink"] == want["uplink"]
        assert {op: cb[0] for op, cb in run["counts"].items()
                if op != "staged" and cb[0]} == {
                    "all_reduce_flat": ROUNDS, "all_gather_rows": ROUNDS}


def test_submesh_grid_of_one_by_two_in_a_world_of_four(worlds, ref):
    """``make_client_mesh(2, model=2)`` in the world of 4: the 1 x 2 grid
    of ranks 0-1 is the one-rank mesh's round bit for bit (a 2-D round is
    the 1-D round of its C rows), and the reference's unsharded round
    within 2e-5."""
    jparams, jlog = ref["runs"]["flat"]
    for r in worlds[4]["ranks"][:2]:
        assert r["sub_grid_shape"] == ({"clients": 1, "model": 2}, True)
        run = r["sub_grid"]
        _assert_same(run["params"], r["sub_one"]["params"])
        assert run["losses"] == r["sub_one"]["losses"]
        assert run["uplink"] == r["sub_one"]["uplink"]
        _near_reference(run, jparams, jlog)
        assert run["counts"]["all_gather_model"][0] > 0


def test_ranks_outside_a_submesh_raise(worlds):
    for r in worlds[4]["ranks"][2:]:
        assert r["sub_shape"] == ({"clients": 2}, False)
        assert r["sub_grid_shape"] == ({"clients": 1, "model": 2}, False)
        for name in ("sub", "sub_grid"):
            assert r[name] == (f"rank {r['rank']} is not in this client "
                               "mesh of ranks 0..1: only they run its "
                               "rounds")
