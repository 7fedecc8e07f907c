"""Port VGG-9, optimizers and ClientUpdate against the reference, on the
reduced VGG-9 with weights carried across as numpy."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.federated import client as jclient  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import opt as jopt  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.federated import client as tclient  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.optim import opt as topt  # noqa: E402

EQUIV_TOL = 2e-5   # benchmarks/round_engine_bench.py:59
JCFG, TCFG = jcnn.VGGConfig().reduced(), tcnn.VGGConfig().reduced()


def _tree_close(a, b, atol=EQUIV_TOL):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol,
                                   rtol=0)


@pytest.fixture(scope="module")
def setup():
    jp = jcnn.init_params(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(0)
    batch = {"images": rng.normal(size=(3, 8, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(3, 8)).astype(np.int32)}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), batch


def _client(batch, i):
    return ({k: jnp.asarray(v[i]) for k, v in batch.items()},
            {k: torch.from_numpy(v[i]) for k, v in batch.items()})


def test_config_matches_reference():
    for jc, tc in [(jcnn.VGGConfig(), tcnn.VGGConfig()), (JCFG, TCFG)]:
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.fc_in() == tc.fc_in() and jc.num_layers == tc.num_layers


def test_init_params_layout_matches_reference():
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcnn.VGGConfig())
    tp = tcnn.init_params(tcnn.VGGConfig(), torch.Generator().manual_seed(0),
                          device="cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(params_to_numpy(tp))
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(params_to_numpy(tp))):
        assert j.shape == t.shape and t.dtype == np.float32
    # same init scales: He-normal conv weights, 1/fan_in fc weights
    np.testing.assert_allclose(tp["conv7"]["w"].std().item(),
                               float(jnp.std(jp["conv7"]["w"])), rtol=0.02)


def test_forward_loss_accuracy_match_reference(setup):
    jp, tp, batch = setup
    jb, tb = _client(batch, 0)
    np.testing.assert_allclose(tcnn.forward(tp, TCFG, tb["images"]).numpy(),
                               jcnn.forward(jp, JCFG, jb["images"]),
                               atol=EQUIV_TOL, rtol=0)
    np.testing.assert_allclose(tcnn.classify_loss(tp, TCFG, tb).item(),
                               float(jcnn.classify_loss(jp, JCFG, jb)),
                               atol=EQUIV_TOL, rtol=0)
    assert tcnn.accuracy(tp, TCFG, tb).item() == \
        float(jcnn.accuracy(jp, JCFG, jb))


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("opt_name", ["sgd", "sgd_momentum_wd", "adamw"])
def test_local_update_matches_reference(setup, steps, opt_name):
    """Local params and mean loss after 1 and 2 optimizer steps."""
    jp, tp, batch = setup
    # AdamW with eps=1e-3, not 1e-8: the conv bias ``b`` feeds straight into
    # batch norm, so its true gradient is 0 and both frameworks return
    # rounding noise (~1e-9) there; with eps=1e-8 Adam's m/√v turns that
    # noise's sign into a full ±lr step, which no two summation orders agree
    # on. eps=1e-3 keeps those steps ~1e-9 while every real gradient still
    # goes through the m/√v normalisation.
    make = {"sgd": lambda m: m.sgd(0.05),
            "sgd_momentum_wd": lambda m: m.sgd(0.05, momentum=0.9,
                                               weight_decay=1e-3),
            "adamw": lambda m: m.adamw(1e-3, eps=1e-3,
                                       weight_decay=1e-2)}[opt_name]
    jup = jclient.make_local_update(
        lambda p, b: jcnn.classify_loss(p, JCFG, b), make(jopt), steps)
    tup = tclient.make_local_update(
        lambda p, b: tcnn.classify_loss(p, TCFG, b), make(topt), steps)
    jb, tb = _client(batch, 1)
    jl, jloss = jax.jit(jup)(jp, jb)
    tl, tloss = tup(tp, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=EQUIV_TOL,
                               rtol=0)
    _tree_close(params_to_numpy(tl), jl)


def test_vmapped_clients_match_reference(setup):
    """K clients stacked under torch.func.vmap, as under jax.vmap."""
    jp, tp, batch = setup
    jup = jclient.plain_sgd_client(
        lambda p, b: jcnn.classify_loss(p, JCFG, b), 0.05)
    tup = tclient.plain_sgd_client(
        lambda p, b: tcnn.classify_loss(p, TCFG, b), 0.05)
    jl, jloss = jax.jit(jax.vmap(jup, in_axes=(None, 0)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tloss = torch.func.vmap(tup, in_dims=(None, 0))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl["conv0"]["w"].shape == (3, 3, 3, 3, 8)
    np.testing.assert_allclose(tloss.numpy(), jloss, atol=EQUIV_TOL, rtol=0)
    _tree_close(params_to_numpy(tl), jl)
