"""The port's device-resident multi-round engine against the reference's:
``ClientShards``, the keyed per-round streams, ``_eval_cuts``,
``run_training_scan`` (MLP task of tests/test_round_engine.py and the
quickstart's reduced VGG-9), setting A (int8 + error feedback),
``run_training(sampler="device")`` against the engine bit for bit, and
resume through a checkpoint, the port's and the reference's.

The reference's draws (``round_keys`` → clients, sample indices, algorithm
uniforms) reach the port through the drivers' ``draws`` argument
(:class:`JaxDraws`); the port is never reseeded to match JAX.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data as jdata  # noqa: E402
from repro.checkpoint import save_server_state as jsave  # noqa: E402
from repro.data import ClientShards as JShards  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import run_training_scan as jscan  # noqa: E402
from repro.federated import sampling as jsampling  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.checkpoint import (load_server_state,  # noqa: E402
                                    save_server_state)
from repro_torch.core.wire import CompressionConfig  # noqa: E402
from repro_torch.data import ClientShards  # noqa: E402
from repro_torch.federated import FLConfig as TFLConfig  # noqa: E402
from repro_torch.federated import run_training as trun  # noqa: E402
from repro_torch.federated import run_training_scan as tscan  # noqa: E402
from repro_torch.federated import sampling as tsampling  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

PARAM_TOL = 2e-5   # tests/test_round_engine.py:43
LOSS_TOL = 1e-5    # tests/test_round_engine.py:61
N, K = 8, 4        # tests/test_round_engine.py:14


class JaxDraws:
    """The reference engine's draws for round ``t`` of run ``seed``:
    ``round_keys(PRNGKey(seed), t)`` → (client, batch, algorithm) keys,
    drawn exactly as ``run_training_scan`` draws them
    (``sample_clients_grouped``, the ``randint`` inside
    ``ClientShards.gather``, and ``jax.random.uniform`` on the algorithm
    key, of which ``bernoulli`` is ``uniform < p``).

    ``host=True`` gives the reference host sampler's algorithm key,
    ``fold_in(PRNGKey(seed), t)`` (only ``uniform`` is used then)."""

    def __init__(self, seed, host=False):
        self.base, self.host = jax.random.PRNGKey(seed), host

    def __call__(self, t):
        if self.host:
            return _JaxRound(None, None, jax.random.fold_in(self.base, t))
        return _JaxRound(*jsampling.round_keys(self.base, t))


class _JaxRound:
    def __init__(self, ck, bk, ak):
        self.ck, self.bk, self.ak = ck, bk, ak

    def clients(self, num_clients, k, num_groups=1):
        return torch.from_numpy(np.asarray(jsampling.sample_clients_grouped(
            self.ck, num_clients, k, num_groups)).astype(np.int64))

    def indices(self, sizes, batch):
        sizes = jnp.asarray(sizes.numpy().astype(np.int32))
        j = jax.random.randint(self.bk, (sizes.shape[0], batch), 0,
                               sizes[:, None])
        return torch.from_numpy(np.asarray(j).astype(np.int64))

    def uniform(self, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(self.ak, tuple(shape))))


# ----------------------------------------------------------------------
# the MLP task of tests/test_round_engine.py, in both packages
# ----------------------------------------------------------------------
def jmlp_params(key=0):
    ks = jax.random.split(jax.random.PRNGKey(key), 3)
    return {"l1": {"w": jax.random.normal(ks[0], (3072, 16)) * 0.02,
                   "b": jnp.zeros((16,))},
            "head": {"w": jax.random.normal(ks[1], (16, 10)) * 0.1,
                     "b": jnp.zeros((10,))}}


def jmlp_loss(params, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = jax.nn.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    logp = jax.nn.log_softmax(h @ params["head"]["w"] + params["head"]["b"])
    return -jnp.take_along_axis(logp, batch["labels"][:, None],
                                axis=-1).mean()


def tmlp_loss(params, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    logp = torch.log_softmax(h @ params["head"]["w"] + params["head"]["b"],
                             dim=-1)
    return -torch.take_along_dim(logp, batch["labels"].long()[:, None],
                                 dim=-1).mean()


def to_torch(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


@pytest.fixture(scope="module")
def task():
    """(reference params, port params, reference data, port data)."""
    jtrain, _ = jdata.make_image_dataset(num_train=320, num_test=16, seed=1)
    ttrain, _ = tdata.make_image_dataset(num_train=320, num_test=16, seed=1)
    jp = jmlp_params()
    return (jp, to_torch(jp),
            jdata.FederatedData(jtrain.xs, jtrain.ys,
                                jdata.iid_partition(jtrain.ys, N, seed=0)),
            tdata.FederatedData(ttrain.xs, ttrain.ys,
                                tdata.iid_partition(ttrain.ys, N, seed=0)))


def cfg(cls, algo="fedldf", mode="vmap", **kw):
    return cls(algo=algo, num_clients=N, clients_per_round=K, top_n=2,
               mode=mode, batch_per_client=8, **kw)


def max_diff(got, want):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                               jax.tree.leaves(want)))


def assert_trees_close(got, want, atol=PARAM_TOL):
    assert max_diff(got, want) <= atol


def assert_same(a, b):
    """Bit for bit, over nested dicts (None matches None)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    la, lb = jax.tree.leaves(params_to_numpy(a)), \
        jax.tree.leaves(params_to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def assert_runs_match(tp, tlog, jp, jlog, atol=PARAM_TOL):
    assert tlog.rounds == jlog.rounds
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                               rtol=0)
    assert_trees_close(tp, jp, atol)
    assert tlog.meter.rounds == jlog.meter.rounds
    assert tlog.meter.uplink_bytes == pytest.approx(jlog.meter.uplink_bytes)
    assert [t for t, _, _ in tlog.test_errors] == \
        [t for t, _, _ in jlog.test_errors]


# ----------------------------------------------------------------------
# ClientShards
# ----------------------------------------------------------------------
def _parts(kind, n_samples=60):
    if kind == "unequal":
        return [np.arange(0, 30), np.arange(30, 35), np.arange(35, 37),
                np.arange(37, 60)]
    return tdata.iid_partition(np.zeros(n_samples), 4, seed=3)


@pytest.mark.parametrize("kind,cap", [("iid", None), ("unequal", None),
                                      ("unequal", 4), ("unequal", 1)],
                         ids=["iid", "unequal", "capped", "cap1"])
def test_client_shards_match_reference(kind, cap):
    xs = np.arange(60, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                             np.float32)
    ys = np.arange(60).astype(np.int32)
    parts = _parts(kind)
    js = JShards.from_federated(jdata.FederatedData(xs, ys, parts), cap)
    ts = ClientShards.from_federated(tdata.FederatedData(xs, ys, parts),
                                     cap)
    np.testing.assert_array_equal(ts.part_idx.numpy(),
                                  np.asarray(js.part_idx))
    np.testing.assert_array_equal(ts.part_sizes.numpy(),
                                  np.asarray(js.part_sizes))
    assert ts.part_idx.dtype == ts.part_sizes.dtype == torch.int32
    np.testing.assert_array_equal(ts.data_sizes().numpy(),
                                  np.asarray(js.data_sizes()))
    assert ts.num_clients == js.num_clients == 4
    assert ts.bytes_per_device() == js.bytes_per_device()
    moved = ts.to("cpu")
    assert moved.x_key == "images" and torch.equal(moved.xs, ts.xs)
    # the padding contract: every slot of row c is a sample of client c
    for c, p in enumerate(parts):
        assert set(ts.part_idx[c].tolist()) <= set(p.tolist())


def test_client_shards_refuse_cap_below_one():
    data = tdata.FederatedData(np.zeros((4, 1)), np.zeros(4),
                               [np.arange(2), np.arange(2, 4)])
    jd = jdata.FederatedData(data.xs, data.ys, data.parts)
    with pytest.raises(ValueError):
        JShards.from_federated(jd, 0)
    with pytest.raises(ValueError, match="max_shard_cap"):
        ClientShards.from_federated(data, 0)


@pytest.mark.parametrize("seed", [0, 7])
def test_gather_matches_reference_on_the_same_key(seed):
    """The port's gather of the reference's own index draw equals the
    reference's ``gather(clients, batch, key)``, with a batch larger than
    the small shards (cyclic pad never read past |D_c|)."""
    xs = np.random.default_rng(seed).normal(size=(60, 2, 3)).astype(
        np.float32)
    ys = np.arange(60).astype(np.int32)
    parts = _parts("unequal")
    js = JShards.from_federated(jdata.FederatedData(xs, ys, parts))
    ts = ClientShards.from_federated(tdata.FederatedData(xs, ys, parts))
    clients = np.array([3, 1, 2], np.int64)
    key = jax.random.PRNGKey(seed)
    want = js.gather(jnp.asarray(clients), 16, key)
    j = _JaxRound(None, key, None).indices(ts.part_sizes[clients], 16)
    got = ts.gather(torch.from_numpy(clients), j)
    for name in ("images", "labels"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert set(got["labels"][1].tolist()) <= set(parts[1].tolist())


# ----------------------------------------------------------------------
# The keyed streams
# ----------------------------------------------------------------------
class TestKeyedStreams:
    """Mirror of tests/test_round_engine.py ``TestHostKeySchedule`` for the
    port's streams, plus the sampler's invariants."""

    @staticmethod
    def _seeds(seed, t):
        return {tsampling.stream_seed(seed, t, s) for s in range(3)}

    def test_streams_disjoint_across_seeds_and_rounds(self):
        rounds = [0, 1, 2, 100003, 100004]
        seen = {}
        for s in range(4):
            for t in rounds:
                for x in self._seeds(s, t):
                    assert x not in seen, (s, t, seen.get(x))
                    seen[x] = (s, t)

    def test_seed_zero_not_degenerate(self):
        for t in range(4):
            assert t not in self._seeds(0, t)
            assert len(self._seeds(0, t)) == 3

    def test_pure_function_of_seed_and_round(self):
        a, b = tsampling.KeyedDraws(5)(3), tsampling.KeyedDraws(5)(3)
        assert torch.equal(a.clients(50, 20), b.clients(50, 20))
        sizes = torch.tensor([7, 1, 300])
        assert torch.equal(a.indices(sizes, 33), b.indices(sizes, 33))
        assert torch.equal(a.uniform((4, 9)), b.uniform((4, 9)))
        c = tsampling.KeyedDraws(5)(4)
        assert not torch.equal(a.uniform((4, 9)), c.uniform((4, 9)))

    @pytest.mark.parametrize("n,k", [(10, 6), (50, 20), (3, 3), (4, 9)])
    def test_clients_distinct_in_range(self, n, k):
        for s in range(5):
            c = tsampling.KeyedDraws(s)(s).clients(n, k)
            assert c.dtype == torch.int64
            assert len(set(c.tolist())) == len(c) == min(k, n)
            assert 0 <= int(c.min()) and int(c.max()) < n

    def test_grouped_clients(self):
        c = tsampling.KeyedDraws(1)(0).clients(12, 6, num_groups=3)
        for g in range(3):
            assert {int(x) // 4 for x in c[2 * g:2 * g + 2]} == {g}
        gen = tsampling.round_generators(1, 0)[0]
        assert torch.equal(
            tsampling.sample_clients_grouped(gen, 12, 6, 1),
            tsampling.sample_clients_torch(
                tsampling.round_generators(1, 0)[0], 12, 6))
        with pytest.raises(ValueError):
            tsampling.sample_clients_grouped(gen, 12, 5, 3)

    def test_indices_within_shard_and_reach_it(self):
        sizes = torch.tensor([1, 2, 5, 1000, 2 ** 31 - 1])
        seen = [set() for _ in sizes]
        for t in range(20):
            j = tsampling.KeyedDraws(0)(t).indices(sizes, 64)
            assert j.shape == (5, 64) and j.dtype == torch.int64
            assert bool((j >= 0).all()) and bool((j < sizes[:, None]).all())
            for r in range(3):
                seen[r] |= set(j[r].tolist())
        assert [len(s) for s in seen[:3]] == [1, 2, 5]

    def test_uniform_in_unit_interval(self):
        u = tsampling.KeyedDraws(2)(9).uniform((64, 64))
        assert u.dtype == torch.float32
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


@pytest.mark.parametrize("rounds", [1, 2, 5, 10, 11])
@pytest.mark.parametrize("eval_every", [1, 2, 3, 10])
@pytest.mark.parametrize("do_eval", [True, False])
def test_eval_cuts_match_reference(rounds, eval_every, do_eval):
    assert tserver._eval_cuts(rounds, eval_every, do_eval) == \
        jserver._eval_cuts(rounds, eval_every, do_eval)


# ----------------------------------------------------------------------
# run_training_scan against the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["vmap", "scan"])
@pytest.mark.parametrize("algo", ["fedldf", "fedavg"])
def test_engine_matches_reference(task, algo, mode):
    jp, tp, jd, td = task
    jparams, jlog = jscan(jp, jmlp_loss, jd, cfg(JFLConfig, algo, mode),
                          rounds=4, seed=3)
    tparams, tlog = tscan(tp, tmlp_loss, td, cfg(TFLConfig, algo, mode),
                          rounds=4, seed=3, device="cpu",
                          draws=JaxDraws(3))
    assert_runs_match(tparams, tlog, jparams, jlog)


def test_engine_eval_blocks_match_reference(task):
    """Eval cuts (cuts 1, 3, 5 for 5 rounds, eval_every=2): the same eval
    rounds and uplink marks, and the trajectory of one block."""
    jp, tp, jd, td = task
    fl_j, fl_t = cfg(JFLConfig), cfg(TFLConfig)
    jparams, jlog = jscan(jp, jmlp_loss, jd, fl_j, rounds=5, seed=0,
                          eval_fn=jax.jit(lambda p: jnp.float32(0.5)),
                          eval_every=2)
    seen = []
    tparams, tlog = tscan(tp, tmlp_loss, td, fl_t, rounds=5, seed=0,
                          eval_fn=lambda p: seen.append(p) or 0.5,
                          eval_every=2, device="cpu", draws=JaxDraws(0))
    assert_runs_match(tparams, tlog, jparams, jlog)
    assert [t for t, _, _ in tlog.test_errors] == [0, 2, 4] and len(seen) == 3
    for (_, _, tu), (_, _, ju) in zip(tlog.test_errors, jlog.test_errors):
        assert tu == pytest.approx(float(ju))
    assert tlog.uplink_mb == pytest.approx(jlog.uplink_mb)


@pytest.fixture(scope="module")
def quickstart():
    """examples/quickstart.py's multi-round call: reduced VGG-9, N=10, K=5,
    n=2, B=8, lr 0.05, 500 images, seed 0."""
    jcfg, tcfg = jcnn.VGGConfig().reduced(), tcnn.VGGConfig().reduced()
    jtrain, _ = jdata.make_image_dataset(num_train=500, num_test=16, seed=2)
    ttrain, _ = tdata.make_image_dataset(num_train=500, num_test=16, seed=2)
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
    return (jp, to_torch(jp),
            jdata.FederatedData(jtrain.xs, jtrain.ys,
                                jdata.iid_partition(jtrain.ys, 10, seed=0)),
            tdata.FederatedData(ttrain.xs, ttrain.ys,
                                tdata.iid_partition(ttrain.ys, 10, seed=0)),
            jcfg, tcfg)


def _qs_fl(cls, mode="vmap"):
    return cls(algo="fedldf", num_clients=10, clients_per_round=5, top_n=2,
               lr=0.05, mode=mode, batch_per_client=8)


def _jqs_loss(p, b):
    return jcnn.classify_loss(p, jcnn.VGGConfig().reduced(), b)


def _tqs_loss(p, b):
    return tcnn.classify_loss(p, tcnn.VGGConfig().reduced(), b)


def test_quickstart_multi_round_matches_reference(quickstart):
    """The quickstart's run_training_scan call, 3 rounds, in the port."""
    jp, tp, jd, td, _, _ = quickstart
    jparams, jlog = jscan(jp, _jqs_loss, jd, _qs_fl(JFLConfig), rounds=3,
                          seed=0)
    tparams, tlog = tscan(tp, _tqs_loss, td, _qs_fl(TFLConfig), rounds=3,
                          seed=0, device="cpu", draws=JaxDraws(0))
    assert_runs_match(tparams, tlog, jparams, jlog)
    assert tlog.meter.savings_frac == pytest.approx(jlog.meter.savings_frac)


def _setting_a(cls, comp_cls):
    return cfg(cls, compression=comp_cls(bits=8, error_feedback=True))


def test_engine_setting_a_matches_reference(task):
    """int8 levels + error feedback through the engine. A last-bit
    difference in the locals can move an element on a .5 boundary to the
    next int8 level, so each leaf may differ by one quantization step of
    its unit on top of 2e-5 (as tests/test_torch_compressed_round.py)."""
    from repro.core.wire import CompressionConfig as JComp
    jp, tp, jd, td = task
    jparams, jlog = jscan(jp, jmlp_loss, jd, _setting_a(JFLConfig, JComp),
                          rounds=3, seed=0)
    tparams, tlog = tscan(tp, tmlp_loss, td,
                          _setting_a(TFLConfig, CompressionConfig),
                          rounds=3, seed=0, device="cpu",
                          draws=JaxDraws(0))
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                               rtol=0)
    assert tlog.meter.uplink_bytes == pytest.approx(jlog.meter.uplink_bytes)
    tn, jn = params_to_numpy(tparams), jax.tree.map(np.asarray, jparams)
    for key in tn:
        step = max(float(np.abs(np.asarray(v)).max())
                   for v in jax.tree.leaves(jn[key])) / 127.0
        for x, y in zip(jax.tree.leaves(tn[key]), jax.tree.leaves(jn[key])):
            np.testing.assert_allclose(x, y, atol=PARAM_TOL + step, rtol=0)
    tres = tlog.final_state["client"]["residual"]
    jres = jlog.final_state["client"]["residual"]
    assert jax.tree.structure(params_to_numpy(tres)) == \
        jax.tree.structure(jax.tree.map(np.asarray, jres))


# ----------------------------------------------------------------------
# run_training(sampler="device") == run_training_scan, bit for bit
# ----------------------------------------------------------------------
SAME_CASES = {
    "fedldf_vmap": dict(algo="fedldf"),
    "fedldf_scan": dict(algo="fedldf", mode="scan"),
    "fedavg_scan": dict(algo="fedavg", mode="scan"),
    "int8_ef": dict(algo="fedldf",
                    compression=CompressionConfig(bits=8,
                                                  error_feedback=True)),
    "fedlama": dict(algo="fedlama"),
    "random": dict(algo="random"),
}


@pytest.mark.parametrize("case", list(SAME_CASES))
def test_device_sampler_equals_engine_bit_for_bit(task, case):
    _, tp, _, td = task
    fl = cfg(TFLConfig, **SAME_CASES[case])
    kw = dict(rounds=4, seed=11, device="cpu", eval_every=2,
              eval_fn=lambda p: float(p["head"]["b"].sum()))
    ph, lh = trun(tp, tmlp_loss, td, fl, sampler="device", **kw)
    ps, ls = tscan(tp, tmlp_loss, td, fl, **kw)
    assert_same(ph, ps)
    assert lh.losses == ls.losses and lh.rounds == ls.rounds
    assert [e[:2] for e in lh.test_errors] == [e[:2] for e in ls.test_errors]
    assert_same(lh.final_state, ls.final_state)
    assert lh.meter.uplink_bytes == pytest.approx(ls.meter.uplink_bytes)
    assert lh.meter.rounds == ls.meter.rounds == 4


def test_device_sampler_takes_shards_and_differs_by_seed(task):
    _, tp, _, td = task
    fl = cfg(TFLConfig)
    shards = ClientShards.from_federated(td)
    p0, l0 = trun(tp, tmlp_loss, shards, fl, rounds=2, seed=0,
                  sampler="device", device="cpu")
    p1, l1 = trun(tp, tmlp_loss, td, fl, rounds=2, seed=0,
                  sampler="device", device="cpu")
    assert_same(p0, p1)
    _, l2 = trun(tp, tmlp_loss, td, fl, rounds=2, seed=1,
                 sampler="device", device="cpu")
    assert l0.losses != l2.losses


def test_unknown_sampler_is_refused(task):
    _, tp, _, td = task
    with pytest.raises(ValueError, match="sampler"):
        trun(tp, tmlp_loss, td, cfg(TFLConfig), rounds=1, sampler="numpy",
             device="cpu")


# ----------------------------------------------------------------------
# Resume: 2 + 2 rounds == 4, through a checkpoint
# ----------------------------------------------------------------------
RESUME_CASES = {
    "stateless": dict(algo="fedavg"),
    "ef": dict(algo="fedldf", compression=CompressionConfig(
        bits=8, error_feedback=True)),
    "fedlama": dict(algo="fedlama"),
}


def _driver(name):
    if name == "engine":
        return tscan
    return lambda *a, **kw: trun(*a, sampler="device", **kw)


@pytest.mark.parametrize("kind", list(RESUME_CASES))
@pytest.mark.parametrize("driver", ["engine", "host_device_sampler"])
def test_resume_is_bit_identical(task, tmp_path, driver, kind):
    _, tp, _, td = task
    run = _driver(driver)
    fl = cfg(TFLConfig, **RESUME_CASES[kind])
    p4, l4 = run(tp, tmlp_loss, td, fl, rounds=4, seed=2, device="cpu")
    p2, l2 = run(tp, tmlp_loss, td, fl, rounds=2, seed=2, device="cpu")
    path = str(tmp_path / "server.npz")
    save_server_state(path, p2, l2.final_state)
    p_loaded, state = load_server_state(path, device="cpu")
    if kind == "stateless":
        assert state is None
    frozen = None if state is None else params_to_numpy(state)
    p_res, l_res = run(p_loaded, tmlp_loss, td, fl, rounds=2, seed=2,
                       device="cpu", start_round=2, server_state=state)
    assert_same(p_res, p4)
    assert l_res.rounds == [2, 3] and l_res.losses == l4.losses[2:]
    assert_same(l_res.final_state, l4.final_state)
    if state is not None:
        # the driver copied the loaded state once; the caller's is intact
        assert_same(state, params_from_numpy(frozen, "cpu"))


@pytest.mark.parametrize("kind", ["ef", "fedlama"])
def test_port_continues_a_reference_checkpoint(task, tmp_path, kind):
    """A reference checkpoint after 2 rounds, continued for 2 by the port
    with the reference's draws for rounds 2 and 3, ends where the
    reference's 4-round run ends."""
    from repro.core.wire import CompressionConfig as JComp
    jp, _, jd, td = task
    if kind == "ef":
        fl_j = _setting_a(JFLConfig, JComp)
        fl_t = _setting_a(TFLConfig, CompressionConfig)
    else:
        fl_j, fl_t = cfg(JFLConfig, "fedlama"), cfg(TFLConfig, "fedlama")
    j4, jl4 = jscan(jp, jmlp_loss, jd, fl_j, rounds=4, seed=5)
    j2, jl2 = jscan(jp, jmlp_loss, jd, fl_j, rounds=2, seed=5)
    path = str(tmp_path / "reference.npz")
    jsave(path, j2, jl2.final_state)
    p_loaded, state = load_server_state(path, device="cpu")
    tp, tl = tscan(p_loaded, tmlp_loss, td, fl_t, rounds=2, seed=5,
                   start_round=2, server_state=state, device="cpu",
                   draws=JaxDraws(5))
    np.testing.assert_allclose(tl.losses, jl4.losses[2:], atol=LOSS_TOL,
                               rtol=0)
    atol = PARAM_TOL
    if kind == "ef":   # one int8 step of the largest unit, as above
        atol += max(float(np.abs(np.asarray(v)).max())
                    for v in jax.tree.leaves(j4)) / 127.0
    assert_trees_close(tp, j4, atol)
    if kind == "fedlama":
        for name in ("ttl", "interval"):
            np.testing.assert_array_equal(
                tl.final_state["global"][name].numpy(),
                np.asarray(jl4.final_state["global"][name]))


def test_verbose_lines_use_the_reference_format(task, capsys):
    _, tp, _, td = task
    tscan(tp, tmlp_loss, td, cfg(TFLConfig), rounds=3, seed=0,
          eval_fn=lambda p: 0.25, eval_every=2, verbose=True, device="cpu")
    trun(tp, tmlp_loss, td, cfg(TFLConfig), rounds=1, seed=0, verbose=True,
         device="cpu")
    lines = capsys.readouterr().out.splitlines()
    pat = re.compile(r"round +\d+ loss \d+\.\d{4} test_err 0\.2500 uplink "
                     r"\d+\.\dMB")
    assert len(lines) == 3 and all(pat.fullmatch(x) for x in lines[:2])
    assert re.fullmatch(r"round    0 loss \d+\.\d{4}", lines[2])
