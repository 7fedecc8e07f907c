"""The paper's baselines and the other strategies in the port, against the
reference: the random selection policies on the same uniforms, each
strategy's round and ``comm_profile`` (vmap, and scan where the strategy
supports it), each strategy through both engines for 3 rounds with the
reference's draws, FedADP's masks and FedLAMA's intervals on their own,
the ``FLConfig`` option shim, the registry API and the Theorem 1 bound.

The reference's algorithm key reaches the port as the round's ``uniform``
stream (``jax.random.uniform(key, shape)``; ``bernoulli`` is
``uniform < p``)."""
import dataclasses
import warnings
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import (LOSS_TOL, JaxDraws,  # noqa: E402
                               assert_runs_match, assert_trees_close, cfg,
                               jmlp_loss, task, tmlp_loss, to_torch)
from repro.core import convergence as jconv  # noqa: E402
from repro.core import fedadp as jfedadp  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core.units import UnitMap as JUnitMap  # noqa: E402
from repro.core.wire import CompressionConfig as JComp  # noqa: E402
import repro.federated as jfed  # noqa: E402
from repro.federated.strategies import fedlama as jfedlama  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.core import convergence as tconv  # noqa: E402
from repro_torch.core import fedadp as tfedadp  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core.units import UnitMap as TUnitMap  # noqa: E402
from repro_torch.core.wire import CompressionConfig as TComp  # noqa: E402
import repro_torch.federated as tfed  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.strategies import base as tbase  # noqa: E402
from repro_torch.federated.strategies import fedlama as tfedlama  # noqa: E402

_ = task   # the module-scoped fixture, shared with test_torch_engine
NEW_ALGOS = ("random", "hdfl", "fedadp", "fedlp", "fedlama")
K = 4


def _uniform_of(key):
    def uniform(shape):
        return torch.from_numpy(np.array(jax.random.uniform(key,
                                                            tuple(shape))))
    return uniform


# ----------------------------------------------------------------------
# selection policies on the same uniforms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,u,n", [(4, 5, 2), (20, 9, 4), (5, 1, 5)])
def test_random_policies_match_reference(seed, k, u, n):
    key = jax.random.PRNGKey(seed)
    uni = _uniform_of(key)
    np.testing.assert_array_equal(
        tsel.random_per_layer(uni, k, u, n).numpy(),
        np.asarray(jsel.random_per_layer(key, k, u, n)))
    np.testing.assert_array_equal(
        tsel.client_dropout(uni, k, u, n).numpy(),
        np.asarray(jsel.client_dropout(key, k, u, n)))
    for p in (0.25, 0.5, 1.0):
        np.testing.assert_array_equal(
            tsel.bernoulli_per_layer(uni, k, u, p).numpy(),
            np.asarray(jsel.bernoulli_per_layer(key, k, u, p)))


@pytest.mark.parametrize("scores", [[0.5, 0.5, 0.5, 0.5, 0.5],
                                    [0.1, 0.7, 0.7, 0.2, 0.7],
                                    [0.0, 0.0, 0.3, 0.3, 0.0]],
                         ids=["all_equal", "top_tie", "mixed_ties"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_client_dropout_ties_match_lax_top_k(scores, n):
    """Among equal scores the lower client index wins, as with
    ``jax.lax.top_k`` (the reference's client_dropout)."""
    s = np.asarray(scores, np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(s), n)
    want = np.zeros(len(s), np.float32)
    want[np.asarray(idx)] = 1.0
    got = tsel.client_dropout(lambda shape: torch.from_numpy(s), len(s), 3,
                              n)
    np.testing.assert_array_equal(got.numpy(), np.repeat(want[:, None], 3, 1))


def test_bernoulli_rejects_bad_p():
    for p in (0.0, 1.5):
        with pytest.raises(ValueError):
            tsel.bernoulli_per_layer(lambda s: torch.zeros(s), 2, 2, p)


def test_random_strategies_need_a_stream(task):
    _, tp, _, _ = task
    strat = tfed.make_strategy(cfg(tfed.FLConfig, "random"))
    with pytest.raises(ValueError, match="uniform"):
        strat.select(None, None, K, 2, 2, "cpu")


# ----------------------------------------------------------------------
# one round of each strategy, and its comm_profile
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def round_inputs():
    rng = np.random.default_rng(4)
    return {"images": rng.normal(size=(K, 8, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(K, 8)).astype(np.int32),
            "sizes": np.array([40.0, 25.0, 60.0, 35.0], np.float32)}


def _round_pair(task, round_inputs, algo, mode, **kw):
    jp, tp, _, _ = task
    jfl, tfl = cfg(jfed.FLConfig, algo, mode, **kw), \
        cfg(tfed.FLConfig, algo, mode, **kw)
    jumap, tumap = JUnitMap.build(jp), TUnitMap.build(tp)
    key = jax.random.PRNGKey(9)
    jstate = jfed.make_strategy(jfl).init_state(jp, jfl.num_clients)
    tstate = tfed.make_strategy(tfl).init_state(tp, tfl.num_clients)
    jb = {k: jnp.asarray(round_inputs[k]) for k in ("images", "labels")}
    tb = {k: torch.from_numpy(round_inputs[k])
          for k in ("images", "labels")}
    jnew, jm = jax.jit(jfed.build_round_fn(jmlp_loss, jumap, jfl))(
        jp, jb, jnp.asarray(round_inputs["sizes"]), key, jstate)
    tnew, tm = tfed.build_round_fn(tmlp_loss, tumap, tfl)(
        tp, tb, torch.from_numpy(round_inputs["sizes"]), tstate,
        _uniform_of(key))
    return (jnew, jm), (tnew, tm)


@pytest.mark.parametrize("mode", ["vmap", "scan"])
@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_one_round_matches_reference(task, round_inputs, algo, mode):
    (jnew, jm), (tnew, tm) = _round_pair(task, round_inputs, algo, mode)
    np.testing.assert_array_equal(tm["selection"].numpy(),
                                  np.asarray(jm["selection"]))
    assert_trees_close(tnew, jnew)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=0)
    # bytes to f32 precision; savings_frac = 1 − total/fedavg cancels, so
    # it is held to f32 resolution of a ratio near 1
    for name, v in jm["comm"].items():
        assert float(tm["comm"][name]) == pytest.approx(
            float(v), rel=1e-6, abs=1e-6), name
    if algo == "fedlama":
        for name in ("ttl", "interval"):
            np.testing.assert_array_equal(
                tm["state"]["global"][name].numpy(),
                np.asarray(jm["state"]["global"][name]))
        np.testing.assert_allclose(tm["state"]["global"]["disc"].numpy(),
                                   np.asarray(jm["state"]["global"]["disc"]),
                                   rtol=1e-5)


def test_fedlp_quantized_round_matches_reference(task, round_inputs):
    """FedLP under the packed int8 uplink: the keep-mask header is priced
    on top of the packed bytes, as in the reference."""
    (jnew, jm), (tnew, tm) = _round_pair(task, round_inputs, "fedlp", "vmap")
    jp, tp, _, _ = task
    jfl = cfg(jfed.FLConfig, "fedlp", compression=JComp(bits=8))
    tfl = cfg(tfed.FLConfig, "fedlp", compression=TComp(bits=8))
    sel = tm["selection"]
    want = jfed.make_strategy(jfl).comm_profile(
        jnp.asarray(sel.numpy()), JUnitMap.build(jp))
    got = tfed.make_strategy(tfl).comm_profile(sel, TUnitMap.build(tp))
    assert {k: float(v) for k, v in got.items()} == \
        pytest.approx({k: float(v) for k, v in want.items()})


@pytest.mark.parametrize("algo,quantized", [
    (algo, q) for algo in ("fedldf", "fedavg") + NEW_ALGOS
    for q in (False, True) if not (q and algo == "fedadp")])
def test_comm_profile_matches_reference(task, algo, quantized):
    """Every strategy's accounting on the same random selection, and the
    ledger invariant payload + feedback == total (fedadp declares
    supports_quantize=False in both packages)."""
    jp, tp, _, _ = task
    jkw = {"compression": JComp(bits=8)} if quantized else {}
    tkw = {"compression": TComp(bits=8)} if quantized else {}
    jstrat = jfed.make_strategy(cfg(jfed.FLConfig, algo, **jkw))
    tstrat = tfed.make_strategy(cfg(tfed.FLConfig, algo, **tkw))
    jumap, tumap = JUnitMap.build(jp), TUnitMap.build(tp)
    for seed in range(3):
        s = (np.random.default_rng(seed).random((K, jumap.num_units))
             < 0.5).astype(np.float32)
        want = jstrat.comm_profile(jnp.asarray(s), jumap)
        got = tstrat.comm_profile(torch.from_numpy(s), tumap)
        assert set(got) == set(want)
        for name in want:
            assert float(got[name]) == pytest.approx(
                float(want[name]), rel=1e-6, abs=1e-6), name
        assert float(got["uplink_payload"] + got["uplink_feedback"]) == \
            pytest.approx(float(got["uplink_total"]))


# ----------------------------------------------------------------------
# FedADP and FedLAMA pieces
# ----------------------------------------------------------------------
def test_fedadp_masks_and_aggregate_match_reference():
    """Conv (HWIO), dense and bias leaves of the reduced VGG-9, 5 clients;
    one leaf with tied (all-zero) updates exercises the tie order."""
    jp = jcnn.init_params(jax.random.PRNGKey(1), jcnn.VGGConfig().reduced())
    rng = np.random.default_rng(2)
    stacked = jax.tree.map(
        lambda l: (np.asarray(l)[None] + 0.01 * rng.normal(
            size=(5,) + l.shape)).astype(np.float32), jp)
    stacked["conv1"]["b"] = np.broadcast_to(
        np.asarray(jp["conv1"]["b"]), (5,) + jp["conv1"]["b"].shape).copy()
    sizes = np.array([10.0, 30.0, 20.0, 5.0, 15.0], np.float32)
    tp, tstacked = to_torch(jp), to_torch(stacked)
    jstacked = jax.tree.map(jnp.asarray, stacked)
    for keep in (0.2, 0.5):
        want_m = jax.jit(jax.vmap(
            lambda p: jfedadp.neuron_masks(p, jp, keep)))(jstacked)
        got_m = tfedadp.neuron_masks(tstacked, tp, keep)
        for x, y in zip(jax.tree.leaves(params_to_numpy(got_m)),
                        jax.tree.leaves(want_m)):
            np.testing.assert_array_equal(x, np.asarray(y))
        want = jax.jit(lambda s_, z_: jfedadp.aggregate_fedadp(
            s_, jp, z_, keep))(jstacked, jnp.asarray(sizes))
        got = tfedadp.aggregate_fedadp(tstacked, tp, torch.from_numpy(sizes),
                                       keep)
        assert_trees_close(got, want, 1e-6)
        assert tfedadp.comm_bytes(tp, 20, keep) == \
            jfedadp.comm_bytes(jp, 20, keep)


@pytest.mark.parametrize("tau,lam", [(2, 2), (3, 4), (1, 1)])
def test_fedlama_intervals_match_reference(task, tau, lam):
    jp, tp, _, _ = task
    jumap, tumap = JUnitMap.build(jp), TUnitMap.build(tp)
    jstrat = jfed.make_strategy(cfg(jfed.FLConfig, "fedlama",
                                    algo_options=jfed.FedLAMAOptions(tau,
                                                                     lam)))
    tstrat = tfed.make_strategy(cfg(tfed.FLConfig, "fedlama",
                                    algo_options=tfed.FedLAMAOptions(tau,
                                                                     lam)))
    rng = np.random.default_rng(tau)
    for disc in ([0.0, 0.0], [1.0, 1.0], [0.0, 3.0],
                 rng.random(2).tolist(), [2.5e-3, 7.0]):
        d = np.asarray(disc, np.float32)
        np.testing.assert_array_equal(
            tstrat._intervals(torch.from_numpy(d), tumap).numpy(),
            np.asarray(jstrat._intervals(jnp.asarray(d), jumap)))
    assert tfedlama.expected_round_bytes(tumap, K, tau, lam) == \
        jfedlama.expected_round_bytes(jumap, K, tau, lam)


# ----------------------------------------------------------------------
# every strategy through both engines, 3 rounds, the reference's draws
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["vmap", "scan"])
@pytest.mark.parametrize("algo", NEW_ALGOS)
def test_engine_rounds_match_reference(task, algo, mode):
    jp, tp, jd, td = task
    jparams, jlog = jfed.run_training_scan(
        jp, jmlp_loss, jd, cfg(jfed.FLConfig, algo, mode), rounds=3,
        seed=4)
    tparams, tlog = tfed.run_training_scan(
        tp, tmlp_loss, td, cfg(tfed.FLConfig, algo, mode), rounds=3, seed=4,
        device="cpu", draws=JaxDraws(4))
    assert_runs_match(tparams, tlog, jparams, jlog)
    if algo == "fedlama":
        for name in ("ttl", "interval"):
            np.testing.assert_array_equal(
                tlog.final_state["global"][name].numpy(),
                np.asarray(jlog.final_state["global"][name]))


@pytest.mark.parametrize("algo", ["random", "hdfl", "fedlp"])
def test_host_sampler_random_policies_match_reference(task, algo):
    """sampler="host": the reference's numpy clients and batches, and its
    host algorithm key ``fold_in(PRNGKey(seed), t)`` as the uniforms."""
    jp, tp, jd, td = task
    jparams, jlog = jfed.run_training(jp, jmlp_loss, jd,
                                      cfg(jfed.FLConfig, algo), rounds=3,
                                      seed=1, sampler="host")
    tparams, tlog = tfed.run_training(tp, tmlp_loss, td,
                                      cfg(tfed.FLConfig, algo), rounds=3,
                                      seed=1, sampler="host", device="cpu",
                                      draws=JaxDraws(1, host=True))
    assert_runs_match(tparams, tlog, jparams, jlog)


# ----------------------------------------------------------------------
# FLConfig: algo_options and the deprecated flat knobs
# ----------------------------------------------------------------------
def _outcome(pkg, kw):
    """What FLConfig(**kw) does in ``pkg``: ("ok", warning classes,
    normalized fields) or ("raise", exception class)."""
    fed = jfed if pkg == "reference" else tfed
    comp = JComp if pkg == "reference" else TComp
    opts = {"FedADPOptions": fed.FedADPOptions,
            "FedLPOptions": fed.FedLPOptions,
            "FedLAMAOptions": fed.FedLAMAOptions}
    kw = dict(kw)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            if "algo_options" in kw:
                name, args = kw["algo_options"]
                kw["algo_options"] = opts[name](*args)
            if "compression" in kw:
                kw["compression"] = comp(**kw["compression"])
            fl = fed.FLConfig(clients_per_round=4, **kw)
        except Exception as e:   # the outcome under test
            return ("raise", type(e).__name__)
        same = dataclasses.replace(fl) == fl
    fields = {f: getattr(fl, f) for f in (
        "fedadp_keep", "fedlp_p", "fedlama_tau", "fedlama_lam",
        "quantize_bits", "error_feedback")}
    opts_v = (None if fl.algo_options is None else
              (type(fl.algo_options).__name__,
               dataclasses.astuple(fl.algo_options)))
    comp_v = (None if fl.compression is None else
              (fl.compression.bits, fl.compression.error_feedback))
    return ("ok", sorted({w.category.__name__ for w in seen}), fields,
            opts_v, comp_v, same)


SHIM_CASES = {
    "fedadp_flat": dict(algo="fedadp", fedadp_keep=0.3),
    "fedlp_flat": dict(algo="fedlp", fedlp_p=0.25),
    "fedlama_flat": dict(algo="fedlama", fedlama_tau=3, fedlama_lam=4),
    "fedlp_options": dict(algo="fedlp", algo_options=("FedLPOptions",
                                                      (0.25,))),
    "fedlp_options_agreeing_flat": dict(
        algo="fedlp", fedlp_p=0.25, algo_options=("FedLPOptions", (0.25,))),
    "fedlp_conflict": dict(algo="fedlp", fedlp_p=0.75,
                           algo_options=("FedLPOptions", (0.25,))),
    "wrong_options_class": dict(algo="fedlp",
                                algo_options=("FedADPOptions", (0.3,))),
    "options_without_class": dict(algo="fedldf",
                                  algo_options=("FedLPOptions", (0.3,))),
    "bad_flat_value_other_algo": dict(algo="fedldf", fedlp_p=1.5),
    "bad_options_value": dict(algo="fedadp",
                              algo_options=("FedADPOptions", (0.0,))),
    "bad_fedlama": dict(algo="fedlama", fedlama_tau=0),
    "flat_for_other_algo": dict(algo="fedldf", fedadp_keep=0.5),
    "defaults_fedlama": dict(algo="fedlama"),
    "defaults_fedldf": dict(algo="fedldf"),
    "quantize_flat": dict(algo="fedldf", quantize_bits=8),
    "quantize_ef_flat": dict(algo="fedldf", quantize_bits=4,
                             error_feedback=True),
    "ef_without_bits": dict(algo="fedldf", error_feedback=True),
    "quantize_conflict": dict(algo="fedldf", quantize_bits=4,
                              compression={"bits": 8}),
    "quantize_agreeing": dict(algo="fedldf", quantize_bits=8,
                              compression={"bits": 8}),
    "ef_conflict": dict(algo="fedldf", error_feedback=True,
                        compression={"bits": 8}),
    "fedadp_quantized": dict(algo="fedadp", compression={"bits": 8}),
    "fedadp_quantize_flat": dict(algo="fedadp", quantize_bits=8),
    "auto_bits_mirror": dict(algo="fedldf", compression={"bits": "auto"}),
}


@pytest.mark.parametrize("case", list(SHIM_CASES))
def test_option_shim_matches_reference(case):
    assert _outcome("port", SHIM_CASES[case]) == \
        _outcome("reference", SHIM_CASES[case])


def test_option_shim_warning_text():
    with pytest.warns(DeprecationWarning, match="algo_options"):
        tfed.FLConfig(algo="fedlp", clients_per_round=4, fedlp_p=0.25)
    with pytest.warns(DeprecationWarning, match="CompressionConfig"):
        tfed.FLConfig(algo="fedldf", clients_per_round=4, quantize_bits=8)


def test_options_reach_the_strategy():
    opts = tfed.FedADPOptions(keep=0.4)
    strat = tfed.make_strategy(cfg(tfed.FLConfig, "fedadp",
                                   algo_options=opts))
    assert strat.opts is opts
    assert tfed.make_strategy(cfg(tfed.FLConfig, "fedlp")).opts == \
        tfed.FedLPOptions()
    assert tbase.FLStrategy.resolve_options(SimpleNamespace()) is None

    class WithOpts(tbase.FLStrategy):
        options_cls = tfed.FedLPOptions

    assert WithOpts.resolve_options(SimpleNamespace()) == tfed.FedLPOptions()
    with pytest.raises(TypeError, match="FedLPOptions"):
        WithOpts.resolve_options(
            SimpleNamespace(algo_options=tfed.FedADPOptions()))


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
def test_registry_lists_the_references_algorithms_in_order():
    assert tfed.registered_algos() == jfed.registered_algos()
    assert tfed.ALGOS == tserver.ALGOS == jfed.ALGOS
    assert set(tfed.strategy_registry()) == set(jfed.strategy_registry())


def test_register_strategy_override_and_live_algos():
    class Mine(tbase.FLStrategy):
        def select(self, divs, uniform, k, u, n, device):
            return torch.ones((k, u), device=device)

    class Other(Mine):
        pass

    tfed.register_strategy("mine")(Mine)
    try:
        assert "mine" in tfed.ALGOS and "mine" in tserver.ALGOS
        assert tfed.registered_algos()[-1] == "mine"
        tfed.register_strategy("mine")(Mine)            # same class: no-op
        with pytest.raises(ValueError, match="override=True"):
            tfed.register_strategy("mine")(Other)
        tfed.register_strategy("mine", override=True)(Other)
        assert tfed.strategy_registry()["mine"] is Other
        reg = tfed.strategy_registry()
        reg.pop("mine")                                 # a copy
        assert "mine" in tfed.ALGOS
        with pytest.raises(ValueError, match="override=True"):
            tfed.register_strategy("fedavg")(Other)
    finally:
        tfed.unregister_strategy("mine")
    assert "mine" not in tfed.ALGOS
    with pytest.raises(TypeError):
        tfed.register_strategy("x")(object)
    with pytest.raises(ValueError, match="fedlama"):
        tfed.FLConfig(algo="nope")
    with pytest.raises(AttributeError):
        tfed.NOT_A_NAME  # noqa: B018


# ----------------------------------------------------------------------
# Theorem 1
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,k", [(1, 20), (4, 20), (20, 20), (2, 10)])
@pytest.mark.parametrize("xi2", [1e-3, 0.02, 0.5])
def test_convergence_bound_matches_reference(n, k, xi2):
    kw = dict(beta=1.0, xi1=0.05, xi2=xi2, grad_bound=1.0, eta=0.05,
              num_layers=9, n=n, k=k)
    jp, tp = jconv.BoundParams(**kw), tconv.BoundParams(**kw)
    for name in ("contraction_A", "offset_B", "xi2_max", "converges",
                 "asymptotic_gap"):
        assert getattr(tconv, name)(tp) == getattr(jconv, name)(jp), name
    for t in (0, 1, 7):
        assert tconv.gap_bound(tp, t, 0.3) == jconv.gap_bound(jp, t, 0.3)
    np.testing.assert_array_equal(tconv.gap_curve(tp, 12, 0.1),
                                  jconv.gap_curve(jp, 12, 0.1))
