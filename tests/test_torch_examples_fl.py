"""``examples/fl_cifar_vgg_torch.py`` against the reference example's
steps on the CPU: the reference's ``PRNGKey`` params through the bridge
and the same numpy sampling stream (the example samples on the host,
``np.random.default_rng(seed)``). Reduced (N=20, K=10, n=2, B=16, 4,000
images), 2 rounds of fedldf and of fedavg through ``run_training`` with
the eval function, each round from the same params: params within 2e-5,
the uplink bytes and the eval rounds exact, the Theorem 1 value equal;
and the example's own 2-round run of seed 0 within ``TRAJ_TOL``.
(``tests/test_torch_examples_compressed.py`` holds compressed_fl.)
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import LOSS_TOL, PARAM_TOL, max_diff, to_torch  # noqa: E402
from test_torch_examples import load_example  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.federated as jfed  # noqa: E402
from repro.core.convergence import BoundParams, asymptotic_gap  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.federated import run_training as trun  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ROUNDS = 2
# the 2-round trajectory: at seed 0 one client's round-1 local sits on a
# ReLU kink (9.8e-5 off, 9.8e-6 in fedavg's mean), which the example's lr
# 0.08 amplifies to 1.2e-4 over round 2; the limit is about 4x that
# reading, still far below a round's update
TRAJ_TOL = 5e-4


# ----------------------------------------------------------------------
# fl_cifar_vgg
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cifar():
    """Each algorithm's 2 rounds, each round from the same params in both
    packages: round 1 from the reference's ``PRNGKey(0)`` params (driver
    seed 0), round 2 from the reference's round-1 params (seed 1). At the
    example's lr 0.08 one client's round-1 local sits on a ReLU kink
    (ROADMAP Queue 3): 9.8e-5 off, 9.8e-6 in fedavg's mean, which round 2
    amplifies to 1.2e-4 along the 2-round trajectory. Then the example's
    own 2-round run of seed 0 in both packages."""
    fc = load_example("fl_cifar_vgg_torch")
    cfg_t, n_clients, k, n, n_train, n_test, batch = fc.setting(False)
    cfg_j = jcnn.VGGConfig().reduced()
    jtrain, jtest = jdata.make_image_dataset(num_train=n_train,
                                             num_test=n_test, seed=0)
    ttrain, ttest = tdata.make_image_dataset(num_train=n_train,
                                             num_test=n_test, seed=0)
    np.testing.assert_array_equal(ttrain.xs, jtrain.xs)
    jd = jdata.FederatedData(jtrain.xs, jtrain.ys,
                             jdata.iid_partition(jtrain.ys, n_clients,
                                                 seed=0))
    td = tdata.FederatedData(ttrain.xs, ttrain.ys,
                             tdata.iid_partition(ttrain.ys, n_clients,
                                                 seed=0))
    jtb = {"images": jnp.asarray(jtest.xs), "labels": jnp.asarray(jtest.ys)}
    ttb = {"images": torch.from_numpy(ttest.xs),
           "labels": torch.from_numpy(ttest.ys)}
    jloss = functools.partial(lambda c, p, b: jcnn.classify_loss(p, c, b),
                              cfg_j)
    jeval = jax.jit(lambda p: 1.0 - jcnn.accuracy(p, cfg_j, jtb))
    tloss = functools.partial(lambda c, p, b: tcnn.classify_loss(p, c, b),
                              cfg_t)
    out, whole = {}, {}
    for algo in ("fedldf", "fedavg"):
        jfl = jfed.FLConfig(algo=algo, num_clients=n_clients,
                            clients_per_round=k, top_n=n, lr=fc.LR,
                            mode="vmap", batch_per_client=batch)
        tfl = fc.fl_config(algo, n_clients, k, n, batch)
        jp0 = jp = jcnn.init_params(jax.random.PRNGKey(0), cfg_j)
        rounds = []
        for seed in range(ROUNDS):
            got = trun(to_torch(jp), tloss, td, tfl, rounds=1,
                       eval_fn=fc.eval_error(cfg_t, ttb), seed=seed,
                       device="cpu")
            ref = jfed.run_training(jp, jloss, jd, jfl, rounds=1,
                                    eval_fn=jeval, seed=seed)
            rounds.append((got, ref))
            jp = ref[0]
        out[algo] = rounds
        # the example's own run: both rounds of seed 0's stream
        whole[algo] = (
            trun(to_torch(jp0), tloss, td, tfl, rounds=ROUNDS, seed=0,
                 device="cpu"),
            jfed.run_training(jp0, jloss, jd, jfl, rounds=ROUNDS, seed=0))
    return fc, cfg_t, (n, k), out, whole


@pytest.mark.parametrize("algo", ["fedldf", "fedavg"])
def test_fl_cifar_vgg_rounds_match_reference(cifar, algo):
    for (tparams, tlog), (jparams, jlog) in cifar[3][algo]:
        assert max_diff(tparams, jax.tree.map(np.asarray, jparams)) \
            <= PARAM_TOL
        np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                                   rtol=0)
        assert tlog.meter.uplink_bytes == float(jlog.meter.uplink_bytes)
        (tt, te, tb), = tlog.test_errors
        (jt, je, jb), = jlog.test_errors
        assert (tt, tb) == (jt, float(jb))
        # the error counts test images (800): within one image
        assert abs(te - float(je)) <= 1.0 / 800 + 1e-6


@pytest.mark.parametrize("algo", ["fedldf", "fedavg"])
def test_fl_cifar_vgg_two_round_run_matches_reference(cifar, algo):
    """Seed 0's 2-round run in both packages (round 2 on seed 0's own
    draws): params within TRAJ_TOL, the bytes exact, and the losses within
    1e-5 plus a relative 1e-5, as tests/test_torch_compressed_round.py
    holds a loss taken at params that already differ (fedavg's round 2
    starts 9.8e-6 apart)."""
    (tparams, tlog), (jparams, jlog) = cifar[4][algo]
    assert tlog.rounds == list(range(ROUNDS))
    assert max_diff(tparams, jax.tree.map(np.asarray, jparams)) <= TRAJ_TOL
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                               rtol=1e-5)
    assert tlog.meter.uplink_bytes == float(jlog.meter.uplink_bytes)


def test_fl_cifar_vgg_theorem1_matches_reference(cifar):
    fc, cfg_t, (n, k) = cifar[:3]
    for nn, kk in ((n, k), (4, 20), (1, 20)):
        want = asymptotic_gap(BoundParams(
            beta=1.0, xi1=0.05, xi2=0.02, grad_bound=1.0, eta=0.05,
            num_layers=cfg_t.num_layers, n=nn, k=kk))
        assert fc.theorem1_gap(cfg_t.num_layers, nn, kk) == want


def test_fl_cifar_vgg_main_on_the_cpu(cifar, capsys):
    final = cifar[0].main(["--device", "cpu", "--rounds", "1", "--algos",
                           "fedldf,fedadp"])
    assert set(final) == {"fedldf", "fedadp"}
    out = capsys.readouterr().out
    assert "Theorem-1 asymptotic gap bound for (n=2, K=10)" in out
