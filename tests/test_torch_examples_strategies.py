"""``examples/custom_strategy_torch.py`` and ``examples/fedlama_fl_torch.py``
against the reference examples' steps on the CPU, on the same injected
draws (the reference's ``PRNGKey`` params through the bridge, its
uniforms, and ``round_keys`` draws through the engines' ``draws``):

- custom_strategy: the Gumbel top-n selection of both strategies on the
  reference's uniforms, the annealed state counter, a 2-round engine run
  on the reference's draws, and the example's ``main`` on the CPU. The
  examples register their strategies in the global registries; a module
  fixture takes them out again (``tests/test_torch_strategies.py``
  compares the two registries' listings in the same process);
- fedlama: the adapted intervals and the trajectory on the reference's
  draws, the port's save → load → resume bit for bit, and ``main``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import (LOSS_TOL, PARAM_TOL, JaxDraws,  # noqa: E402
                               max_diff, to_torch)
from test_torch_examples import load_example  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.federated as jfed  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.federated as tfed  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

CUSTOM = ("softmax-div", "softmax-div-annealed")


def _jloss(p, b):
    return jcnn.classify_loss(p, jcnn.VGGConfig().reduced(), b)


def _tloss(p, b):
    return tcnn.classify_loss(p, tcnn.VGGConfig().reduced(), b)


def _task(seed=0):
    """The examples' reduced task: 500 images over 10 IID clients, in
    both packages."""
    jtrain, _ = jdata.make_image_dataset(num_train=500, num_test=16,
                                         seed=seed)
    ttrain, _ = tdata.make_image_dataset(num_train=500, num_test=16,
                                         seed=seed)
    return (jdata.FederatedData(jtrain.xs, jtrain.ys,
                                jdata.iid_partition(jtrain.ys, 10, seed=0)),
            tdata.FederatedData(ttrain.xs, ttrain.ys,
                                tdata.iid_partition(ttrain.ys, 10, seed=0)))


# ----------------------------------------------------------------------
# custom_strategy
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def custom():
    """Both examples' strategies, registered in both registries for this
    module's tests and taken out after (the registries are global: a
    later test in this process compares their listings)."""
    tmod = load_example("custom_strategy_torch")
    jmod = load_example("custom_strategy")
    try:
        yield tmod, jmod
    finally:
        for name in CUSTOM:
            tfed.unregister_strategy(name)
            jfed.unregister_strategy(name)
    assert not set(CUSTOM) & set(tfed.ALGOS)
    assert not set(CUSTOM) & set(jfed.ALGOS)


def _custom_fl(cls, algo):
    return cls(algo=algo, num_clients=10, clients_per_round=5, top_n=2,
               lr=0.05, batch_per_client=8)


@pytest.mark.parametrize("t", [None, 0.0, 1.0, 3.0])
def test_custom_selection_on_the_same_uniforms(custom, t):
    """Gumbel top-n of the same divergences on the reference's uniforms of
    ``PRNGKey(7)``: the same selection (``t`` None: softmax-div; else the
    annealed variant at round ``t``)."""
    tmod, jmod = custom
    k, u, n = 5, 6, 2
    divs = np.random.default_rng(3).uniform(0.0, 0.2, (k, u)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(7)

    def uniform(shape):
        return torch.from_numpy(np.array(jax.random.uniform(key, shape)))

    if t is None:
        jsel = jmod.SoftmaxDivergence(_custom_fl(jfed.FLConfig, "softmax-div")
                                      ).select(jnp.asarray(divs), key, k, u,
                                               n)
        tsel = tmod.SoftmaxDivergence(_custom_fl(tfed.FLConfig,
                                                 "softmax-div")).select(
            torch.from_numpy(divs), uniform, k, u, n, "cpu")
    else:
        algo = "softmax-div-annealed"
        js = jmod.AnnealedSoftmaxDivergence(_custom_fl(jfed.FLConfig, algo))
        ts = tmod.AnnealedSoftmaxDivergence(_custom_fl(tfed.FLConfig, algo))
        jsel = js.select_with_state({"global": {"round": jnp.float32(t)}},
                                    jnp.asarray(divs), key, k, u, n)
        tstate = {"global": {"round": torch.tensor(t)}}
        tsel = ts.select_with_state(tstate, torch.from_numpy(divs), uniform,
                                    k, u, n, "cpu")
        nxt = ts.update_state(tstate, tsel, None, None)
        assert float(nxt["global"]["round"]) == t + 1.0
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert (tsel.sum(0) == n).all()


def test_custom_strategy_engine_matches_reference(custom):
    """The annealed variant (``softmax-div``'s select at a temperature
    the state sets) through both engines for 2 rounds on the reference's
    draws: the same trajectory, the counter at 2."""
    jd, td = _task()
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcnn.VGGConfig().reduced())
    for algo in CUSTOM[1:]:
        jparams, jlog = jfed.run_training_scan(
            jp, _jloss, jd, _custom_fl(jfed.FLConfig, algo), rounds=2,
            seed=0)
        tparams, tlog = tfed.run_training_scan(
            to_torch(jp), _tloss, td, _custom_fl(tfed.FLConfig, algo),
            rounds=2, seed=0, device="cpu", draws=JaxDraws(0))
        assert max_diff(tparams, jax.tree.map(np.asarray, jparams)) \
            <= PARAM_TOL
        np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                                   rtol=0)
        assert tlog.meter.uplink_bytes == float(jlog.meter.uplink_bytes)
    assert float(tlog.final_state["global"]["round"]) == \
        float(jlog.final_state["global"]["round"]) == 2.0


def test_custom_strategy_main_on_the_cpu(custom):
    log, log2 = custom[0].main(["--device", "cpu", "--rounds", "2"])
    assert "softmax-div" in tfed.ALGOS
    assert float(log2.final_state["global"]["round"]) == 2.0
    assert all(np.isfinite(log.losses))


# ----------------------------------------------------------------------
# fedlama
# ----------------------------------------------------------------------
def test_fedlama_intervals_and_resume_match_reference():
    """FedLAMA (τ'=2, λ=2) for 4 rounds on the reference's draws: the same
    adapted intervals and trajectory; the example's save → load → resume
    at round 2 bit for bit."""
    fm = load_example("fedlama_fl_torch")
    jd, td = _task()
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcnn.VGGConfig().reduced())
    jfl = jfed.FLConfig(algo="fedlama", num_clients=10, clients_per_round=5,
                        top_n=2, lr=0.05, batch_per_client=8,
                        algo_options=jfed.FedLAMAOptions(tau=2, lam=2))
    jparams, jlog = jfed.run_training_scan(jp, _jloss, jd, jfl, rounds=4,
                                           seed=0)
    tfl = fm.fl_config(2, 2)
    tparams, tlog = tfed.run_training_scan(to_torch(jp), _tloss, td, tfl,
                                           rounds=4, seed=0, device="cpu",
                                           draws=JaxDraws(0))
    for key in ("interval", "ttl"):
        np.testing.assert_array_equal(
            tlog.final_state["global"][key].numpy(),
            np.asarray(jlog.final_state["global"][key]))
    assert max_diff(tparams, jax.tree.map(np.asarray, jparams)) <= PARAM_TOL
    assert tlog.meter.uplink_bytes == float(jlog.meter.uplink_bytes)
    assert fm.resume_drift(to_torch(jp), _tloss, td, tfl, 4, "cpu", tparams,
                           draws=JaxDraws(0)) == 0.0


def test_fedlama_main_on_the_cpu(capsys):
    log = load_example("fedlama_fl_torch").main(
        ["--device", "cpu", "--rounds", "4"])
    assert log.meter.rounds == 4
    assert "bit-identical to the uninterrupted 4-round run" in \
        capsys.readouterr().out
