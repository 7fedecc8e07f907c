"""``examples/compressed_fl_torch.py`` against the reference example's
steps on the CPU: the reference's ``PRNGKey`` params through the bridge
and the same numpy sampling stream (``np.random.default_rng(0)``). The
hand-rolled loop over ``build_round_fn``, 2 rounds of int8 + error
feedback, each round from the reference's params: the losses within
1e-5, the uplink bytes exact, and the params after each round, the
residual rows each round gathered and the final residual store within
2e-5 plus one quantization step of their unit, the largest wire scale
either round sent (``tests/test_torch_compressed_round.py``'s rule),
with at most ``FLIP_SHARE`` of the elements past 2e-5.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import LOSS_TOL, PARAM_TOL, to_torch  # noqa: E402
from test_torch_examples import load_example  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.federated as jfed  # noqa: E402
from repro.core.units import UnitMap as JUnitMap  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.core.units import UnitMap as TUnitMap  # noqa: E402
from repro_torch.core.units import tree_leaves  # noqa: E402
from repro_torch.federated.strategies import QuantizedUpload  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ROUNDS = 2
# the share of elements a level flip may move past 2e-5: at most 1.9 %
# in any tree here (a client's store); a store never written back leaves
# 12.9 % of the gathered rows past it
FLIP_SHARE = 0.05


# ----------------------------------------------------------------------
def _reference_loop(params, cfg, data, fl, rounds):
    """examples/compressed_fl.py's loop, in the reference package: the
    params after each round, the residual rows each round gathered, the
    uplink and FedAvg bytes, the losses and the final residual store."""
    umap = JUnitMap.build(params)
    round_fn = jax.jit(jfed.build_round_fn(
        functools.partial(lambda c, p, b: jcnn.classify_loss(p, c, b), cfg),
        umap, fl))
    zero_res = jax.tree.map(lambda l: jnp.zeros_like(l, jnp.float32),
                            params)
    residuals = {i: zero_res for i in range(fl.num_clients)}
    rng = np.random.default_rng(0)
    sizes_all = data.data_sizes()
    uplink = fedavg_ref = 0.0
    after, gathered, losses = [], [], []
    for t in range(rounds):
        clients = jfed.sample_clients(rng, fl.num_clients,
                                      fl.clients_per_round)
        batch = {kk: jnp.asarray(v) for kk, v in
                 data.round_batch(clients, fl.batch_per_client, rng).items()}
        sizes = jnp.asarray(sizes_all[clients])
        res_in = jax.tree.map(lambda *ls: jnp.stack(ls),
                              *[residuals[int(c)] for c in clients])
        params, metrics = round_fn(params, batch, sizes,
                                   jax.random.PRNGKey(t),
                                   {"client": {"residual": res_in}})
        res_out = metrics["state"]["client"]["residual"]
        for i, c in enumerate(clients):
            residuals[int(c)] = jax.tree.map(lambda l: l[i], res_out)
        uplink += float(metrics["comm"]["uplink_total"])
        fedavg_ref += float(metrics["comm"]["fedavg_uplink"])
        losses.append(float(metrics["loss"]))
        after.append(params)
        gathered.append(res_in)
    return after, gathered, uplink, fedavg_ref, losses, residuals


def _unit_of_leaves(umap, tree):
    """Unit index of every leaf, in tree_leaves order (a top-level key of
    VGG-9 is one unit)."""
    return [umap.spans[key][0] for key in sorted(tree)
            for _ in tree_leaves(tree[key])]


def _assert_within_a_step(got, want, units, step):
    """Every element within PARAM_TOL plus one quantization step of its
    unit, and all but FLIP_SHARE of them within PARAM_TOL: an element's
    level may flip across a .5 boundary on the frameworks' last-bit
    difference in local training, which moves it by a step. (A residual is
    under half a step, so the step alone would not tell a store that was
    never written back.)"""
    far = total = 0
    for u, x, y in zip(units, tree_leaves(got), jax.tree.leaves(want)):
        d = np.abs(x.numpy() - np.asarray(y))
        assert d.max() <= PARAM_TOL + float(step[u])
        far += int((d > PARAM_TOL).sum())
        total += d.size
    assert far <= FLIP_SHARE * total, (far, total)


def test_compressed_fl_loop_matches_reference(monkeypatch):
    """The example's loop, each round from the reference's params: round
    2 takes the reference's round-1 params (after round 1 the two differ by
    a few level flips, which lr 0.08 and a loss that jumps from 3.3 to 13.8
    amplify past a step), and its own residual store. Held: the losses,
    the bytes, the params after each round, the rows round 2 gathered from
    the store, and the final store (every client)."""
    cm = load_example("compressed_fl_torch")
    cfg_j, cfg_t = jcnn.VGGConfig().reduced(), tcnn.VGGConfig().reduced()
    jtrain, _ = jdata.make_image_dataset(num_train=2400, num_test=16,
                                         seed=0)
    ttrain, _ = tdata.make_image_dataset(num_train=2400, num_test=16,
                                         seed=0)
    jparts = jdata.dirichlet_partition(jtrain.ys, cm.N_CLIENTS, alpha=1.0,
                                       seed=0)
    tparts = tdata.dirichlet_partition(ttrain.ys, cm.N_CLIENTS, alpha=1.0,
                                       seed=0)
    jp = jcnn.init_params(jax.random.PRNGKey(0), cfg_j)
    jfl = jfed.FLConfig(algo="fedldf", num_clients=cm.N_CLIENTS,
                        clients_per_round=cm.K, top_n=cm.TOP_N, lr=0.08,
                        mode="vmap", batch_per_client=cm.B,
                        compression=jfed.CompressionConfig(
                            bits=8, error_feedback=True))
    jafter, jgathered, jup, jfa, jlosses, jres = _reference_loop(
        jp, cfg_j, jdata.FederatedData(jtrain.xs, jtrain.ys, jparts), jfl,
        ROUNDS)
    # one quantization step a unit: the largest scale the wire sent
    scales, tafter, tgathered = [], [], []
    packed_reduce = QuantizedUpload._packed_reduce

    def recording(self, *a, **kw):
        out = packed_reduce(self, *a, **kw)
        scales.append(out[3]["payload"].scales.amax(dim=0))
        return out

    build = cm.build_round_fn

    def build_injected(*a, **kw):
        round_fn = build(*a, **kw)

        def each_round(params, batch, sizes, state, uniform):
            t = len(tgathered)
            if t:
                params = to_torch(jafter[t - 1])
            tgathered.append(state["client"]["residual"])
            out = round_fn(params, batch, sizes, state, uniform)
            tafter.append(out[0])
            return out
        return each_round

    monkeypatch.setattr(QuantizedUpload, "_packed_reduce", recording)
    monkeypatch.setattr(cm, "build_round_fn", build_injected)
    _, tup, tfa, tlosses, tres = cm.train(
        to_torch(jp), cfg_t, tdata.FederatedData(ttrain.xs, ttrain.ys,
                                                 tparts),
        cm.fl_config(8, True), ROUNDS, "cpu")
    assert len(scales) == len(tafter) == ROUNDS
    step = torch.stack(scales).amax(dim=0).numpy()
    np.testing.assert_allclose(tlosses, jlosses, atol=LOSS_TOL, rtol=0)
    assert (tup, tfa) == (jup, jfa)
    units = _unit_of_leaves(TUnitMap.build(tafter[0]), tafter[0])
    for t in range(ROUNDS):
        _assert_within_a_step(tafter[t], jafter[t], units, step)
        _assert_within_a_step(tgathered[t], jgathered[t], units, step)
    assert set(tres) == set(jres)
    for c in jres:
        _assert_within_a_step(tres[c], jres[c], units, step)


@pytest.mark.parametrize("argv", [["--bits", "8"], ["--bits", "auto"],
                                  ["--bits", "4", "--no-error-feedback"]])
def test_compressed_fl_main_on_the_cpu(argv):
    out = load_example("compressed_fl_torch").main(
        argv + ["--rounds", "1", "--device", "cpu"])
    assert 0 < out["uplink"] < out["fedavg_uplink"]
    assert np.isfinite(out["losses"]).all()
