"""The port's 2-D ('clients', 'model') mesh against the reference, case by
case as ``tests/test_model_axis.py``: FSDP of the params, the frozen base
and the EF residual store over the 'model' axis.

In this process: the specs (``fl_param_specs``, ``residual_store_specs``)
against the reference's on fake meshes (the MLP, full-width VGG-9's 34
leaves and its at-rest bytes a rank, the stacked ``blocks`` and
``experts`` case, an indivisible leaf, ``model=1``), the mesh and
``FLConfig`` errors.

One spawn of 4 gloo CPU ranks (``tests/torch_model_axis_worker.py:world``,
no JAX) runs the grids 2 × 2 and 1 × 4: against the reference's
unsharded run on the same ``round_keys`` draws within the reference's
sharded-vs-unsharded tolerance (2e-5; losses 1e-5) with the comm bytes
exact (fedldf, fedavg, int4 with and without EF, FedADP, the stacked
units, a reduced qwen3 LoRA round on 1 × 4); and with no tolerance, the
host driver against the engine, telemetry on against off, the ledger's
header and tier bytes, ``shard_samples`` against the replicated
placement, resume, 1 × 4 against the 1-rank mesh, every rank's bits,
the collectives a round, the shards' shapes and the gather/slice round
trip. The reference's own 2-D rounds run only when ``REPRO_TEST_DEVICES``
gives JAX the devices.
"""
import dataclasses
import datetime

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.data as jdata  # noqa: E402
import torch_model_axis_worker as w  # noqa: E402
from repro.core import agg_tier_bytes as jtier  # noqa: E402
from repro.core.wire import CompressionConfig as JComp  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import run_training_scan as jscan  # noqa: E402
from repro.federated import sampling as jsampling  # noqa: E402
from repro.launch.mesh import make_client_mesh as jmesh  # noqa: E402
from repro.launch.sharding import fl_param_specs as jspecs  # noqa: E402
from repro.launch.sharding import residual_store_specs as jstore_specs  # noqa: E402,E501
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models.lora import inject_lora as jinject  # noqa: E402
from repro.models.lora import lora_partition as jlora_partition  # noqa: E402
from test_model_axis import FakeMesh, _loss as jmlp_loss  # noqa: E402
from test_model_axis import _mlp_params as jmlp_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.units import tree_leaves  # noqa: E402
from repro_torch.data import lm_federated  # noqa: E402
from repro_torch.federated import FLConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.telemetry import read_ledger, split_runs  # noqa: E402

PARAM_TOL = 2e-5   # tests/test_shard_engine.py:25 (EQUIV_TOL)
LOSS_TOL = 1e-5    # tests/test_round_engine.py:61
GRIDS = [pytest.param(c, m, id=f"{c}x{m}") for c, m in w.GRIDS]
WORLD_TIMEOUT = datetime.timedelta(seconds=180)


def _meta(jtree):
    """The port's shape tree of a reference tree (meta tensors)."""
    return jax.tree.map(lambda l: torch.empty(tuple(l.shape), device="meta"),
                        jtree)


def _as_tuples(jspec_tree):
    return jax.tree.map(tuple, jspec_tree, is_leaf=lambda x: isinstance(x, P))


def _jstacked_params():
    """``tests/test_model_axis.py:test_2d_mesh_stacked_units_model``'s."""
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    return {"embed": {"w": jax.random.normal(ks[0], (3072, 16)) * 0.02},
            "blocks": {"w": jax.random.normal(ks[1], (2, 16, 16)) * 0.1,
                       "b": jnp.zeros((2, 16))},
            "head": {"w": jax.random.normal(ks[2], (16, 10)) * 0.1}}


def _jstacked_loss(p, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = x @ p["embed"]["w"]
    for i in range(2):
        h = jax.nn.relu(h @ p["blocks"]["w"][i] + p["blocks"]["b"][i])
    logp = jax.nn.log_softmax(h @ p["head"]["w"])
    return -jnp.take_along_axis(logp, batch["labels"][:, None],
                                axis=-1).mean()


def _draws(parts, n, k, b, u, rounds):
    """The reference engine's draws of ``round_keys(PRNGKey(0), t)``."""
    sizes = np.asarray([len(p_) for p_ in parts], np.int32)
    out, base = {}, jax.random.PRNGKey(0)
    for t in range(rounds):
        ck, bk, ak = jsampling.round_keys(base, t)
        c = np.asarray(jsampling.sample_clients_grouped(ck, n, k, 1))
        j = jax.random.randint(bk, (k, b), 0, jnp.asarray(sizes[c])[:, None])
        out[t] = {"clients": c.astype(np.int64),
                  "indices": np.asarray(j).astype(np.int64),
                  "uniform": np.array(jax.random.uniform(ak, (k, u)))}
    return out


def _jcfg(algo="fedldf", **kw):
    return JFLConfig(algo=algo, num_clients=w.N, clients_per_round=w.K,
                     top_n=w.TOP_N, mode="vmap", batch_per_client=w.B, **kw)


def _jrun_cfg(name):
    if name in ("fedavg", "fedadp"):
        return _jcfg(name)
    if name in ("int4_ef", "int4"):
        return _jcfg(compression=JComp(bits=4,
                                       error_feedback=name == "int4_ef"))
    return _jcfg()


@pytest.fixture(scope="module")
def task():
    train, _ = jdata.make_image_dataset(num_train=320, num_test=16, seed=1)
    parts = jdata.iid_partition(train.ys, w.N, seed=0)
    rounds = max(w.ROUNDS.values())
    jcfg = dataclasses.replace(
        jconfigs.get_config("qwen3-1.7b").reduced(),
        param_dtype="float32", compute_dtype="float32")
    jlm = jinject(jax.random.PRNGKey(1),
                  jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=2)
    rng = np.random.default_rng(5)

    def perturb(path, leaf):      # so that the round moves every factor
        if path[-1].key == "b" and "lora" in jax.tree_util.keystr(path):
            return leaf + 0.05 * rng.normal(size=leaf.shape).astype(
                np.float32)
        return leaf
    jlm = jax.tree_util.tree_map_with_path(perturb, jlm)
    tokens, domains = jdata.make_lm_dataset(
        num_sequences=32, seq_len=17, vocab=jcfg.vocab_size, num_domains=4,
        seed=0)
    jlm_data = jdata.lm_federated(tokens, domains, w.LM_N)
    return {
        "params": jax.tree.map(np.asarray, jmlp_params()),
        "stacked": jax.tree.map(np.asarray, _jstacked_params()),
        "xs": train.xs, "ys": train.ys, "parts": parts,
        "draws": _draws(parts, w.N, w.K, w.B, 2, rounds),
        "sdraws": _draws(parts, w.N, w.K, w.B, 4, rounds),
        "jd": jdata.FederatedData(train.xs, train.ys, parts),
        "lm": (jcfg, jlm, jlm_data, lm_federated(tokens, domains, w.LM_N)),
        # fedldf draws no algorithm uniforms: a (K, 1) placeholder
        "lm_draws": _draws(jlm_data.parts, w.LM_N, w.LM_K, 4, 1, 1),
    }


@pytest.fixture(scope="module")
def runs(task, tmp_path_factory):
    """The world's per-rank results and, computed meanwhile, the
    reference's unsharded runs on the same draws."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("grid")
    jcfg, jlm, jlm_data, tlm_data = task["lm"]
    job = {k_: task[k_] for k_ in ("params", "stacked", "xs", "ys", "parts",
                                   "draws", "sdraws", "lm_draws")}
    job.update(ledger=str(tmp / "ledger_{c}x{m}.jsonl"),
               lm_cfg=w.lm_task_config(
                   tconfigs.get_config("qwen3-1.7b").reduced()),
               lm_params=jax.tree.map(np.asarray, jlm), lm_data=tlm_data)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(tmesh.spawn, w.world, 4, (job,),
                          store_dir=str(tmp), timeout=WORLD_TIMEOUT)
        jp, jd = jmlp_params(), task["jd"]
        ref = {name: jscan(jp, jmlp_loss, jd, _jrun_cfg(name), rounds=r,
                           seed=0)
               for name, r in w.ROUNDS.items() if name != "stacked"}
        ref["stacked"] = jscan(_jstacked_params(), _jstacked_loss, jd,
                               _jcfg(), rounds=w.ROUNDS["stacked"], seed=0)
        ref["lora"] = jscan(
            jlm, jtfm.make_lm_loss(jcfg), jlm_data,
            JFLConfig(algo="fedldf", num_clients=w.LM_N,
                      clients_per_round=w.LM_K, top_n=1, batch_per_client=4,
                      partition=jlora_partition(jlm)), rounds=1, seed=0)
        ranks = fut.result()
    return {"ranks": ranks, "ref": ref, "ledger": job["ledger"]}


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


def _near_reference(run, jrun, tol=PARAM_TOL):
    jparams, jlog = jrun
    np.testing.assert_allclose(run["losses"], jlog.losses, atol=LOSS_TOL,
                               rtol=0)
    assert run["uplink"] == float(jlog.meter.uplink_bytes)
    assert _max_diff(run["params"], jparams) <= tol


def _grid(runs, c, m, rank=0):
    return runs["ranks"][rank][(c, m)]


# ----------------------------------------------------------------------
# trajectories against the reference's unsharded run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["fedldf", "fedavg"])
@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_mesh_matches_unsharded(runs, algo, c, m):
    _near_reference(_grid(runs, c, m)[algo], runs["ref"][algo])


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_mesh_error_feedback(runs, c, m):
    """The EF rows flow 'model'-sharded through gather, round and scatter,
    reproduce the unsharded EF run, and keep their cross-round effect."""
    g = _grid(runs, c, m)
    _near_reference(g["int4_ef"], runs["ref"]["int4_ef"])
    assert _max_diff(g["int4_ef"]["params"], g["int4"]["params"]) > 1e-6, \
        "error feedback lost its effect under model sharding"


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_mesh_quantized_no_ef(runs, c, m):
    _near_reference(_grid(runs, c, m)["int4"], runs["ref"]["int4"])


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_mesh_fedadp(runs, c, m):
    """FedADP's element-wise denominator is sliced with the numerators."""
    _near_reference(_grid(runs, c, m)["fedadp"], runs["ref"]["fedadp"])


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_mesh_stacked_units_model(runs, c, m):
    """Stacked-key params: the unit axis stays whole while trailing dims
    are model-sharded; the trajectory matches the unsharded run."""
    g = _grid(runs, c, m)
    _near_reference(g["stacked"], runs["ref"]["stacked"])
    assert g["blocks_w"] == (2, 16, 16 // m)


def test_lora_round_on_1x4_with_the_frozen_base_sharded(runs):
    """One fedldf round of the reduced qwen3 with rank-2 adapters on 1 × 4:
    the frozen base held as 1/4 shards, against the reference's unsharded
    round."""
    lora = _grid(runs, 1, 4)["lora"]
    _near_reference(lora, runs["ref"]["lora"])
    assert lora["frozen_sharded_leaves"] > 0
    assert lora["frozen_shard_bytes"] < lora["frozen_bytes"] // 2
    for r in runs["ranks"][1:]:
        _assert_same(r[(1, 4)]["lora"]["params"], lora["params"])


# ----------------------------------------------------------------------
# the port against itself, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_host_driver_matches_engine(runs, c, m):
    g = _grid(runs, c, m)
    _assert_same(g["host"]["params"], g["fedldf"]["params"])
    assert g["host"]["losses"] == g["fedldf"]["losses"]
    assert g["host"]["uplink"] == g["fedldf"]["uplink"]


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_telemetry_on_equals_off_and_its_ledger(runs, c, m):
    g = _grid(runs, c, m)
    _assert_same(g["tele"]["params"], g["fedldf"]["params"])
    assert g["tele"]["losses"] == g["fedldf"]["losses"]
    segs = split_runs(read_ledger(runs["ledger"].format(c=c, m=m)))
    assert [s_["meta"]["run_id"] for s_ in segs] == [f"grid{c}x{m}"]
    meta = segs[0]["meta"]
    assert meta["mesh"] == {"clients": c, "model": m}
    assert meta["agg"] == {"group_size": c, "num_groups": 1, "tiers": 1}
    payload = 4.0 * sum(v.size for v in _leaves(g["fedldf"]["params"]))
    want = jtier(payload / m, c, 0)
    assert len(segs[0]["rounds"]) == w.ROUNDS["fedldf"]
    for rec in segs[0]["rounds"]:
        for key, v in want.items():
            assert rec["comm"][key] == v, key


def test_2d_shard_samples_equals_the_replicated_placement(runs):
    for r in runs["ranks"]:
        g = r[(2, 2)]
        _assert_same(g["shard"]["params"], g["rep_aff"]["params"])
        assert g["shard"]["losses"] == g["rep_aff"]["losses"]


@pytest.mark.parametrize("name", ["fedldf", "int4_ef"])
def test_1x4_equals_the_one_rank_mesh(runs, name):
    """C = 1: the column's sum is the identity and gather and slice only
    move data, so 1 × 4 gives the 1-rank mesh's bits."""
    for r in runs["ranks"]:
        g = r[(1, 4)]
        _assert_same(g[name]["params"], g[f"one_{name}"]["params"])
        assert g[name]["losses"] == g[f"one_{name}"]["losses"]
        assert g[name]["uplink"] == g[f"one_{name}"]["uplink"]


def test_1x4_resumes_from_a_whole_ef_store(runs):
    """A whole store (the 1-rank mesh's ``final_state``) given to a grid
    is cut to the rank's shards: 2 rounds on the 1-rank mesh, then 1 on
    1 × 4, give the 3-round 1 × 4 run bit for bit."""
    for r in runs["ranks"]:
        g = r[(1, 4)]
        _assert_same(g["resume_whole"]["params"], g["int4_ef"]["params"])
        _assert_same(g["resume_whole"]["state"], g["int4_ef"]["state"])
        assert g["resume_whole"]["losses"] == g["int4_ef"]["losses"][2:]


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_resume_on_the_same_grid(runs, c, m):
    """2 rounds, then 1 from the rank's shards of the EF store: the 3-round
    run's params and last loss, bit for bit."""
    g = _grid(runs, c, m)
    _assert_same(g["resume"]["params"], g["int4_ef"]["params"])
    assert g["resume"]["losses"] == g["int4_ef"]["losses"][2:]


@pytest.mark.parametrize("c,m", GRIDS)
def test_every_rank_holds_the_same_params_and_each_column_its_shards(
        runs, c, m):
    ranks = [r[(c, m)] for r in runs["ranks"]]
    assert [g["coords"] for g in ranks] == [divmod(r, m) for r in range(4)]
    for name in list(w.ROUNDS) + ["host", "tele"]:
        for g in ranks[1:]:
            _assert_same(g[name]["params"], ranks[0][name]["params"])
            assert g[name]["losses"] == ranks[0][name]["losses"]
    # the EF store's shards: the same bits down a column, different
    # halves across a row
    for g in ranks:
        col0 = ranks[g["coords"][1]]
        _assert_same(g["int4_ef"]["state"], col0["int4_ef"]["state"])
    if m > 1:
        a = ranks[0]["int4_ef"]["state"]["residual"]["l1"]["w"]
        b_ = ranks[1]["int4_ef"]["state"]["residual"]["l1"]["w"]
        assert a.shape == b_.shape and not np.array_equal(a, b_)


@pytest.mark.parametrize("c,m", GRIDS)
def test_collectives_a_round(runs, c, m):
    """A fedldf round a rank: 1 all-gather over the row (the params, one
    buffer), 1 divergence all-gather and 1 all-reduce over the column;
    the run adds 1 row gather at its end (the whole params it returns).
    Setting int4+EF adds the K EF rows' gather, the rows riding the
    round's one row gather."""
    g = _grid(runs, c, m)
    r_ = w.ROUNDS["fedldf"]
    calls = {op: cb[0] for op, cb in g["fedldf"]["counts"].items()
             if op != "staged" and cb[0]}
    assert calls == {"all_gather_model": r_ + 1, "all_reduce_flat": r_,
                     "all_gather_rows": r_}
    ef = {op: cb[0] for op, cb in g["int4_ef"]["counts"].items()
          if op != "staged" and cb[0]}
    r_ = w.ROUNDS["int4_ef"]
    assert ef == {"all_gather_model": r_ + 1, "all_reduce_flat": r_,
                  "all_gather_rows": 2 * r_}
    # the reduce's payload: the shard's numerators, the (U,) denominator
    # and the loss sum, f32
    n_shard = (3072 // m) * 16 + 16 + (16 // m) * 10 + 10
    assert g["fedldf"]["counts"]["all_reduce_flat"][1] == \
        w.ROUNDS["fedldf"] * 4 * (n_shard + 2 + 1)
    # the row gather's payload: the sharded leaves' bytes
    assert g["fedldf"]["counts"]["all_gather_model"][1] == \
        (w.ROUNDS["fedldf"] + 1) * 4 * ((3072 // m) * 16 + (16 // m) * 10)


@pytest.mark.parametrize("c,m", GRIDS)
def test_param_and_store_shards(runs, c, m):
    g = _grid(runs, c, m)
    assert g["shape"] == {"clients": c, "model": m}
    assert g["axis_names"] == ("clients", "model")
    assert g["param_shards"] == {"l1/w": (3072 // m, 16), "l1/b": (16,),
                                 "head/w": (16 // m, 10), "head/b": (10,)}
    assert g["store"]["l1/w"] == ((w.N, 3072 // m, 16), "torch.float32")
    assert g["store"]["l1/b"] == ((w.N, 16), "torch.float32")
    # the driver keeps the store as the rank's shards
    assert g["int4_ef"]["state"]["residual"]["l1"]["w"].shape == \
        (w.N, 3072 // m, 16)
    assert g["strategy_specs"]["client"]["residual"] == {
        "l1": {"w": ("model", None), "b": ()},
        "head": {"w": ("model", None), "b": ()}}


@pytest.mark.parametrize("c,m", GRIDS)
def test_tree_all_gather_of_tree_shard_slice_is_exact(runs, c, m):
    for r in runs["ranks"]:
        assert r[(c, m)]["roundtrip"]
        assert r[(c, m)]["roundtrip_calls"] == 2


# ----------------------------------------------------------------------
# the specs against the reference's, in this process
# ----------------------------------------------------------------------
def _both_specs(jtree, shape):
    fake = FakeMesh(shape)
    return (tsharding.fl_param_specs(_meta(jtree), fake),
            _as_tuples(jspecs(jtree, fake)))


@pytest.mark.parametrize("shape", [{"clients": 2, "model": 2},
                                   {"clients": 1, "model": 4},
                                   {"clients": 4}, {"clients": 4,
                                                    "model": 1}])
def test_fl_param_specs_model_only(shape):
    params = {"l1": {"w": jnp.zeros((3072, 16)), "b": jnp.zeros((16,))},
              "head": {"w": jnp.zeros((16, 10)), "b": jnp.zeros((10,))},
              "odd": {"x": jnp.zeros((7, 9))}}
    got, want = _both_specs(params, shape)
    assert got == want
    m = shape.get("model", 1)
    if m > 1:
        assert got["l1"]["w"] == ("model", None)
        assert got["odd"]["x"] == (None, None)     # indivisible
    else:
        assert all(s == () for s in tree_leaves(got))
    fake = FakeMesh(shape)
    assert tsharding.residual_store_specs(_meta(params), fake) == \
        _as_tuples(jstore_specs(params, fake))


def test_fl_param_specs_never_shards_unit_axes():
    params = {"blocks": {"w": jnp.zeros((2, 16, 16)),
                         "b": jnp.zeros((2, 16))},
              "experts": {"w": jnp.zeros((8, 6, 6))}}
    got, want = _both_specs(params, {"clients": 2, "model": 2})
    assert got == want
    assert got["blocks"]["w"][0] is None
    assert got["experts"]["w"] == (None, None, "model")


@pytest.mark.parametrize("c,m,params_b,store_b", [
    (2, 2, 9_430_952, 471_547_600), (1, 4, 4_727_016, 236_350_800),
    (4, 1, 18_838_824, 941_941_200)])
def test_vgg9_specs_and_bytes_a_rank(c, m, params_b, store_b):
    """Full-width VGG-9 (34 leaves): the specs leaf for leaf, and the
    params and the N = 50 EF store a rank at rest (shapes only)."""
    jtree = jax.eval_shape(lambda k_: jcnn.init_params(k_, jcnn.VGGConfig()),
                           jax.random.PRNGKey(0))
    shape = {"clients": c, "model": m} if m > 1 else {"clients": c}
    got, want = _both_specs(jtree, shape)
    assert got == want and len(tree_leaves(got)) == 34
    fake = FakeMesh(shape)
    meta = _meta(jtree)
    shards = [tsharding.shard_shape(l.shape, s_, m) for l, s_ in
              zip(tree_leaves(meta), tree_leaves(got))]
    assert sum(4 * int(np.prod(s_)) for s_ in shards) == params_b
    store = tsharding.init_residual_store(meta, 50, fake)
    assert sum(l.numel() * l.element_size()
               for l in tree_leaves(store)) == store_b
    if m > 1:
        assert sum(1 for s_ in tree_leaves(got) if "model" in s_) == 9


def test_make_client_mesh_model_factor():
    with pytest.raises(ValueError, match="must divide"):
        tmesh.make_client_mesh(model=2, device="cpu")
    with pytest.raises(ValueError):
        jmesh(1, model=2)
    one = tmesh.make_client_mesh(1, device="cpu")
    assert one.axis_names == ("clients",) and tmesh.model_mesh_size(one) == 1
    grid = tmesh.ClientMesh(4, 3, "cpu", None, model=2)
    assert (grid.client_size, grid.model_size) == (2, 2)
    assert (grid.client_rank, grid.model_rank) == (1, 1)
    assert tmesh.model_mesh_size(grid) == 2
    assert tmesh.client_mesh_size(grid) == 2
    with pytest.raises(AssertionError):   # K=5 not divisible by clients=2
        FLConfig(num_clients=10, clients_per_round=5, top_n=2, mesh=grid)
    with pytest.raises(AssertionError):
        JFLConfig(num_clients=10, clients_per_round=5, top_n=2,
                  mesh=FakeMesh({"clients": 2, "model": 2}))
    with pytest.raises(ValueError, match="must divide"):
        tmesh.ClientMesh(4, 0, "cpu", None, model=3)


def test_the_round_on_a_grid_needs_the_layout():
    from repro_torch.federated import build_round_fn
    grid = tmesh.ClientMesh(2, 0, "cpu", None, model=2)
    fl = FLConfig(num_clients=4, clients_per_round=2, top_n=1, mesh=grid)
    with pytest.raises(ValueError, match="ModelLayout"):
        build_round_fn(w.mlp_loss, None, fl)


@pytest.mark.parametrize("c,m", GRIDS)
def test_2d_mesh_matches_the_references_sharded_round(task, runs, c, m):
    if len(jax.devices()) < c * m:
        pytest.skip(f"needs {c * m} JAX devices; set REPRO_TEST_DEVICES=8")
    jrun = jscan(jmlp_params(), jmlp_loss, task["jd"],
                 _jcfg(mesh=jmesh(c * m, model=m)),
                 rounds=w.ROUNDS["fedldf"], seed=0)
    _near_reference(_grid(runs, c, m)["fedldf"], jrun)
