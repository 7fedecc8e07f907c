"""The port's FedLDF round and host driver against the reference, end to end
on the reduced VGG-9: one round in both modes, then 3 rounds of
``run_training(sampler="host")`` for fedldf and fedavg."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data as jdata  # noqa: E402
from repro.configs import vgg9_cifar10 as jvgg9  # noqa: E402
from repro.core import UnitMap as JUnitMap  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import build_round_fn as jbuild  # noqa: E402
from repro.federated import make_local_update as jmake_local_update  # noqa: E402
from repro.federated import run_training as jrun  # noqa: E402
from repro.federated import sample_clients as jsample  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import vgg9_cifar10 as tvgg9  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core.units import UnitMap as TUnitMap  # noqa: E402
from repro_torch.federated import FLConfig as TFLConfig  # noqa: E402
from repro_torch.federated import build_round_fn as tbuild  # noqa: E402
from repro_torch.federated import run_training as trun  # noqa: E402
from repro_torch.federated import sample_clients as tsample  # noqa: E402
from repro_torch.federated.strategies import (register_strategy,  # noqa: E402
                                              unregister_strategy)
from repro_torch.federated.strategies.builtin import FedLDF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

EQUIV_TOL = 2e-5   # benchmarks/round_engine_bench.py:59
JCFG, TCFG = jcnn.VGGConfig().reduced(), tcnn.VGGConfig().reduced()
K, TOP_N, B, N = 5, 2, 8, 10


def _jloss(p, b):
    return jcnn.classify_loss(p, JCFG, b)


def _tloss(p, b):
    return tcnn.classify_loss(p, TCFG, b)


def _fl(cls, algo, mode):
    return cls(algo=algo, num_clients=N, clients_per_round=K, top_n=TOP_N,
               mode=mode, batch_per_client=B)


def _assert_trees_close(got, want, atol=EQUIV_TOL):
    for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(x, np.asarray(y), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def params():
    jp = jcnn.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def round_inputs():
    rng = np.random.default_rng(1)
    return {"images": rng.normal(size=(K, B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(K, B)).astype(np.int32),
            "sizes": np.array([100.0, 150.0, 80.0, 120.0, 100.0],
                              np.float32)}


@pytest.fixture(scope="module")
def datasets():
    jtrain, _ = jdata.make_image_dataset(num_train=400, num_test=16, seed=2)
    ttrain, _ = tdata.make_image_dataset(num_train=400, num_test=16, seed=2)
    return (jdata.FederatedData(jtrain.xs, jtrain.ys,
                                jdata.iid_partition(jtrain.ys, N, seed=0)),
            tdata.FederatedData(ttrain.xs, ttrain.ys,
                                tdata.iid_partition(ttrain.ys, N, seed=0)))


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_one_fedldf_round_matches_reference(params, round_inputs, mode):
    """Quickstart's step-by-step outputs for one round: the divergence
    matrix, an identical selection, the new global model and the comm
    dict."""
    jp, tp = params
    inp = round_inputs
    jbatch = {k: jnp.asarray(inp[k]) for k in ("images", "labels")}
    tbatch = {k: torch.from_numpy(inp[k]) for k in ("images", "labels")}
    jumap = JUnitMap.build(jp)
    locals_, _ = jax.vmap(jmake_local_update(_jloss, jsgd(0.05)),
                          in_axes=(None, 0))(jp, jbatch)
    jdivs = jax.vmap(lambda p: jumap.divergence(p, jp))(locals_)
    jnew, jm = jax.jit(jbuild(_jloss, jumap, _fl(JFLConfig, "fedldf",
                                                 mode)))(
        jp, jbatch, jnp.asarray(inp["sizes"]), jax.random.PRNGKey(0))

    ops.reset_launch_counts()
    tnew, tm = tbuild(_tloss, TUnitMap.build(tp),
                      _fl(TFLConfig, "fedldf", mode))(
        tp, tbatch, torch.from_numpy(inp["sizes"]))
    np.testing.assert_allclose(tm["divergence"].numpy(), jdivs, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tm["selection"].numpy(),
                                  np.asarray(jm["selection"]))
    assert tm["selection"].sum(0).tolist() == [TOP_N] * jumap.num_units
    _assert_trees_close(tnew, jnew)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               atol=EQUIV_TOL, rtol=0)
    assert {k: float(v) for k, v in tm["comm"].items()} == \
        {k: float(v) for k, v in jm["comm"].items()}
    assert ops.launch_counts() == {"sqdiff_rowsum": 0,
                                   "masked_accumulate": 0}


@pytest.mark.parametrize("divs", [
    [[1.0, 2.0, 2.0], [2.0, 2.0, 1.0], [2.0, 0.5, 2.0], [0.0, 2.0, 2.0]],
    [[3.0] * 4] * 5,
    [[0.1, 0.0], [0.1, 0.0], [0.2, 0.0], [0.1, 0.0], [0.05, 0.0]],
], ids=["mixed", "all_equal", "zeros_and_ties"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_topn_divergence_ties_match_lax_top_k(divs, n):
    """Among equal divergences the lower client index is picked first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order for ties)."""
    d = np.asarray(divs, np.float32)
    np.testing.assert_array_equal(
        tsel.topn_divergence(torch.from_numpy(d), n).numpy(),
        np.asarray(jsel.topn_divergence(jnp.asarray(d), n)))


def test_topn_divergence_rejects_bad_n():
    with pytest.raises(ValueError):
        tsel.topn_divergence(torch.ones(3, 2), 4)


@pytest.mark.parametrize("mode", ["vmap", "scan"])
@pytest.mark.parametrize("algo", ["fedldf", "fedavg"])
def test_run_training_host_sampler_matches_reference(params, datasets, algo,
                                                     mode):
    """3 rounds of run_training(sampler="host"): same clients and batches
    from one seed, losses and final params within 2e-5, equal comm.

    The driver seed is one whose batches put no ReLU input within the two
    frameworks' f32 forward difference (~5e-6) of the kink. Driver seeds 2,
    4 and 5 on this data do: with seed 4, client 2 of round 1 has a
    batch-norm output at 1.07e-6, the reference's f32 ReLU gate there
    disagrees with float64 while the port's agrees, and the reference's
    conv gradients move by up to 4.6e-3
    (test_port_gradient_matches_float64_near_a_relu_kink; ROADMAP Queue 3).
    """
    jp, tp = params
    jd, td = datasets
    jparams, jlog = jrun(jp, _jloss, jd, _fl(JFLConfig, algo, mode),
                         rounds=3, seed=0, sampler="host")
    tparams, tlog = trun(tp, _tloss, td, _fl(TFLConfig, algo, mode),
                         rounds=3, seed=0, sampler="host", device="cpu")
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=EQUIV_TOL,
                               rtol=0)
    _assert_trees_close(tparams, jparams)
    assert tlog.meter.uplink_bytes == jlog.meter.uplink_bytes
    assert tlog.meter.downlink_bytes == jlog.meter.downlink_bytes
    assert tlog.meter.fedavg_uplink_bytes == jlog.meter.fedavg_uplink_bytes
    assert tlog.rounds == jlog.rounds and tlog.uplink_mb == jlog.uplink_mb


def test_port_gradient_matches_float64_near_a_relu_kink(params, datasets):
    """Round 1, client 2 of driver seed 4: one batch-norm output lies 1e-6
    from the ReLU kink. The port's f32 gradient stays on the float64 one."""
    _, tp = params
    _, td = datasets
    rng = np.random.default_rng(4)
    clients = tsample(rng, N, K)
    batch = td.round_batch(clients, B, rng)
    b32 = {k: torch.from_numpy(v[2]) for k, v in batch.items()}
    b64 = {"images": b32["images"].double(), "labels": b32["labels"]}
    p64 = {k: {n: v.double() for n, v in sub.items()}
           for k, sub in tp.items()}
    g32 = torch.func.grad(_tloss)(tp, b32)
    g64 = torch.func.grad(_tloss)(p64, b64)
    for key in ("conv0", "conv1", "conv2"):
        np.testing.assert_allclose(g32[key]["w"].numpy(),
                                   g64[key]["w"].numpy(), atol=1e-5, rtol=0)


def test_run_training_eval_hook(params, datasets):
    _, tp = params
    _, td = datasets
    images = torch.from_numpy(td.xs[:16])
    labels = torch.from_numpy(td.ys[:16])
    seen = []

    def eval_fn(p):
        seen.append(p)
        return 1.0 - tcnn.accuracy(p, TCFG, {"images": images,
                                             "labels": labels})

    _, log = trun(tp, _tloss, td, _fl(TFLConfig, "fedldf", "vmap"),
                  rounds=3, seed=0, eval_fn=eval_fn, eval_every=2,
                  device="cpu")
    assert [t for t, _, _ in log.test_errors] == [0, 2]
    assert all(0.0 <= err <= 1.0 for _, err, _ in log.test_errors)
    assert len(seen) == 2


def test_data_pipeline_is_byte_identical():
    """The numpy copies give the reference's arrays for one seed."""
    for (ja, jb), (ta, tb) in [
            (jdata.make_image_dataset(num_train=64, num_test=8, seed=3),
             tdata.make_image_dataset(num_train=64, num_test=8, seed=3))]:
        for j, t in ((ja, ta), (jb, tb)):
            np.testing.assert_array_equal(j.xs, t.xs)
            np.testing.assert_array_equal(j.ys, t.ys)
    labels = np.random.default_rng(0).integers(0, 10, size=500)
    for jp_, tp_ in zip(jdata.iid_partition(labels, 7, seed=1),
                        tdata.iid_partition(labels, 7, seed=1)):
        np.testing.assert_array_equal(jp_, tp_)
    for jp_, tp_ in zip(jdata.dirichlet_partition(labels, 5, seed=2),
                        tdata.dirichlet_partition(labels, 5, seed=2)):
        np.testing.assert_array_equal(jp_, tp_)
    jtok, jdom = jdata.make_lm_dataset(num_sequences=16, seq_len=8,
                                       vocab=32, seed=5)
    ttok, tdom = tdata.make_lm_dataset(num_sequences=16, seq_len=8,
                                       vocab=32, seed=5)
    np.testing.assert_array_equal(jtok, ttok)
    jfd = jdata.lm_federated(jtok, jdom, 4, seed=1)
    tfd = tdata.lm_federated(ttok, tdom, 4, seed=1)
    np.testing.assert_array_equal(jfd.data_sizes(), tfd.data_sizes())
    parts = tdata.iid_partition(labels, 7, seed=1)
    jfed = jdata.FederatedData(np.arange(500.0), labels, parts)
    tfed = tdata.FederatedData(np.arange(500.0), labels, parts)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        jc, tc = jsample(jr, 7, 3), tsample(tr, 7, 3)
        np.testing.assert_array_equal(jc, tc)
        jb_, tb_ = jfed.round_batch(jc, 4, jr), tfed.round_batch(tc, 4, tr)
        for key in jb_:
            np.testing.assert_array_equal(jb_[key], tb_[key])


def test_vgg9_config_matches_reference():
    assert dataclasses.asdict(tvgg9.config()) == \
        dataclasses.asdict(jvgg9.config())
    jfl = jvgg9.fl_config()
    for mode in ("vmap", "scan"):
        tfl = tvgg9.fl_config(mode=mode)
        for field in dataclasses.fields(tfl):
            want = mode if field.name == "mode" else getattr(jfl, field.name)
            assert getattr(tfl, field.name) == want, field.name


@pytest.mark.parametrize("kwargs,exc", [
    ({"algo": "nope"}, ValueError),
    ({"algo": "random"}, NotImplementedError),
    ({"algo": "fedlama"}, NotImplementedError),
    ({"mode": "pmap"}, ValueError),
    ({"top_n": 0}, ValueError),
    ({"top_n": 21}, ValueError),
])
def test_flconfig_validation(kwargs, exc):
    with pytest.raises(exc):
        TFLConfig(**kwargs)


def test_run_training_other_samplers_not_ported(params, datasets):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trun(params[1], _tloss, datasets[1], _fl(TFLConfig, "fedldf", "vmap"),
             rounds=1, sampler="jax", device="cpu")


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_round_threads_strategy_state(params, round_inputs, mode):
    """select_with_state / update_state: a plugin strategy's state goes in
    with the round and comes back updated, in both modes."""

    class CountingFedLDF(FedLDF):
        def update_state(self, state, selection, divs, umap):
            return {"count": state["count"] + selection.sum(0)}

    register_strategy("counting_fedldf")(CountingFedLDF)
    try:
        _, tp = params
        fl = _fl(TFLConfig, "counting_fedldf", mode)
        umap = TUnitMap.build(tp)
        batch = {k: torch.from_numpy(round_inputs[k])
                 for k in ("images", "labels")}
        state = {"count": torch.zeros(umap.num_units)}
        _, m = tbuild(_tloss, umap, fl)(
            tp, batch, torch.from_numpy(round_inputs["sizes"]), state)
        assert m["state"]["count"].tolist() == [float(TOP_N)] * \
            umap.num_units
    finally:
        unregister_strategy("counting_fedldf")


def test_comm_accumulator_matches_meter_and_reference(params):
    """comm_acc_* over rounds, pulled once, equals the per-round CommMeter,
    and each round's stats equal the reference's round_comm."""
    from repro.core import comm as jcomm
    from repro_torch.core import comm as tcomm
    jp, tp = params
    jumap, tumap = JUnitMap.build(jp), TUnitMap.build(tp)
    rng = np.random.default_rng(6)
    acc, meter = tcomm.comm_acc_init("cpu"), tcomm.CommMeter()
    for _ in range(3):
        sel = (rng.random((K, jumap.num_units)) < 0.4).astype(np.float32)
        stats = tcomm.round_comm(torch.from_numpy(sel), tumap)
        want = jcomm.round_comm(jnp.asarray(sel), jumap)
        assert {k: float(v) for k, v in stats.items()} == \
            {k: float(v) for k, v in want.items()}
        acc = tcomm.comm_acc_update(acc, stats)
        meter.update(stats)
    assert tcomm.CommMeter.from_accumulator(acc) == meter
    assert meter.rounds == 3 and 0.0 < meter.savings_frac < 1.0


def test_fedavg_stacked_matches_reference(params):
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as tagg
    jp, _ = params
    rng = np.random.default_rng(7)
    stacked = jax.tree.map(
        lambda l: rng.normal(size=(K,) + l.shape).astype(np.float32), jp)
    sizes = rng.integers(10, 200, size=K).astype(np.float32)
    got = tagg.fedavg_stacked(params_from_numpy(stacked, "cpu"),
                              torch.from_numpy(sizes))
    want = jagg.fedavg_stacked(jax.tree.map(jnp.asarray, stacked),
                               jnp.asarray(sizes))
    _assert_trees_close(got, want, atol=1e-6)
