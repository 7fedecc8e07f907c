"""The port's packed compressed uplink against the reference, on the reduced
VGG-9: one packed reduction on injected local models, one whole round, and
3 rounds of ``run_training(sampler="host")``, in the two settings the card
runs (A: int8 levels with error feedback; B: int4 levels without), plus the
packed path against the port's legacy unfused chain and the refusals."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data as jdata  # noqa: E402
from repro.core import UnitMap as JUnitMap  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import build_round_fn as jbuild  # noqa: E402
from repro.federated import make_strategy as jmake_strategy  # noqa: E402
from repro.federated import run_training as jrun  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import (params_from_numpy, params_to_numpy,  # noqa: E402
                                state_from_numpy, state_to_numpy)
from repro_torch.configs import vgg9_cifar10 as tvgg9  # noqa: E402
from repro_torch.core.units import UnitMap as TUnitMap  # noqa: E402
from repro_torch.core.units import tree_leaves  # noqa: E402
from repro_torch.federated import CompressionConfig  # noqa: E402
from repro_torch.federated import FLConfig as TFLConfig  # noqa: E402
from repro_torch.federated import build_round_fn as tbuild  # noqa: E402
from repro_torch.federated import build_round_scan as tbuild_scan  # noqa: E402
from repro_torch.federated import make_strategy as tmake_strategy  # noqa: E402
from repro_torch.federated import run_training as trun  # noqa: E402
from repro_torch.federated.strategies import QuantizedUpload  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

EQUIV_TOL = 2e-5   # benchmarks/round_engine_bench.py:59
JCFG, TCFG = jcnn.VGGConfig().reduced(), tcnn.VGGConfig().reduced()
K, TOP_N, B, N = 5, 2, 8, 10
SETTINGS = {"A_int8_ef": {"bits": 8, "error_feedback": True},
            "B_int4": {"bits": 4, "error_feedback": False}}


def _jloss(p, b):
    return jcnn.classify_loss(p, JCFG, b)


def _tloss(p, b):
    return tcnn.classify_loss(p, TCFG, b)


def _fl(cls, comp_cls, setting, **kw):
    return cls(algo="fedldf", num_clients=N, clients_per_round=K,
               top_n=TOP_N, batch_per_client=B,
               compression=comp_cls(**SETTINGS[setting], **kw))


def _unit_of_leaves(umap, tree):
    """Unit index of every leaf, in tree_leaves order (stacked keys do not
    occur in VGG-9, so a top-level key is one unit)."""
    return [umap.spans[key][0] for key in sorted(tree)
            for _ in tree_leaves(tree[key])]


def _assert_comm_equal_to_f32(got, want):
    """Comm dicts equal to f32: within one f32 ulp (XLA may rewrite
    ``1 − a/b`` under jit)."""
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=np.finfo(np.float32).eps, atol=0,
                                   err_msg=key)


def _assert_close_per_unit(got, want, umap, step, base=EQUIV_TOL):
    """Leaves within ``base`` plus one quantization step of their unit:
    a level may flip across a .5 boundary on the frameworks' last-bit
    difference in local training (``step``: (U,) largest scale)."""
    units = _unit_of_leaves(umap, got)
    for u, x, y in zip(units, tree_leaves(params_to_numpy(got)),
                       jax.tree.leaves(want)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=0,
                                   atol=base + float(step[u]))


def _np_params(cfg, seed):
    """VGG-9 weights in the reference's layout and scales (He-normal conv,
    1/fan_in fc), drawn with numpy: ``jcnn.init_params`` would spend
    seconds compiling its random draws."""
    rng = np.random.default_rng(seed)
    params, cin = {}, cfg.in_channels
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": (rng.normal(size=(3, 3, cin, cout))
                  * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            "b": np.zeros(cout, np.float32),
            "scale": np.ones(cout, np.float32),
            "bias": np.zeros(cout, np.float32)}
        cin = cout
    params["fc"] = {
        "w": (rng.normal(size=(cfg.fc_in(), cfg.num_classes))
              * np.sqrt(1.0 / cfg.fc_in())).astype(np.float32),
        "b": np.zeros(cfg.num_classes, np.float32)}
    return params


@pytest.fixture(scope="module")
def params():
    jp = _np_params(JCFG, 0)
    return jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def round_inputs():
    rng = np.random.default_rng(1)
    return {"images": rng.normal(size=(K, B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(K, B)).astype(np.int32),
            "sizes": np.array([100.0, 150.0, 80.0, 120.0, 100.0],
                              np.float32)}


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()


@pytest.mark.parametrize("setting", list(SETTINGS) + ["int4_ef"])
def test_packed_reduce_injected_locals_matches_reference(params, setting):
    """The reference's local models, divergences, selection and residual
    rows go in as numpy; levels, scales, bits, wire bytes, new params,
    residual rows and the comm dict come out equal."""
    spec = SETTINGS.get(setting, {"bits": 4, "error_feedback": True})
    jp, tp = params
    jumap, tumap = JUnitMap.build(jp), TUnitMap.build(tp)
    rng = np.random.default_rng(2)
    locals_np = jax.tree.map(
        lambda l: (np.asarray(l) + 0.02 * rng.normal(size=(K,) + l.shape))
        .astype(np.float32), jp)
    res_np = (jax.tree.map(lambda l: (1e-3 * rng.normal(size=(K,) + l.shape))
                           .astype(np.float32), jp)
              if spec["error_feedback"] else None)
    sizes = np.array([100.0, 150.0, 80.0, 120.0, 100.0], np.float32)
    jlocals = jax.tree.map(jnp.asarray, locals_np)
    jdivs = jax.vmap(lambda p: jumap.divergence(p, jp))(jlocals)
    jstrat = jmake_strategy(JFLConfig(
        algo="fedldf", num_clients=N, clients_per_round=K, top_n=TOP_N,
        compression=jwire.CompressionConfig(**spec)))
    jsel = jstrat.select_with_state(None, jdivs, jax.random.PRNGKey(0), K,
                                    jumap.num_units, TOP_N)
    jres = None if res_np is None else jax.tree.map(jnp.asarray, res_np)
    jnew, jrows, jw = jax.jit(
        lambda loc, sel, divs, res: jstrat.uplink_round(
            loc, jp, jumap, sel, divs, jnp.asarray(sizes), res))(
        jlocals, jsel, jdivs, jres)

    tstrat = tmake_strategy(TFLConfig(
        algo="fedldf", num_clients=N, clients_per_round=K, top_n=TOP_N,
        compression=CompressionConfig(**spec)))
    tsel = torch.tensor(np.asarray(jsel))
    tnew, trows, tw = tstrat.uplink_round(
        params_from_numpy(locals_np, "cpu"), tp, tumap, tsel,
        torch.tensor(np.asarray(jdivs)), torch.from_numpy(sizes),
        None if res_np is None else params_from_numpy(res_np, "cpu"))

    # the wire payload: the reference's quantizer under vmap, then packed
    v = jax.tree.map(lambda loc, g: loc - g, jlocals, jp)
    if jres is not None:
        v = jax.tree.map(lambda d, e: d + e, v, jres)
    jlv, js = jax.vmap(lambda d: jwire.quantize_units(d, jumap, jw["bits"]))(
        v)
    jpacked = jwire.pack_levels(jlv, jstrat.comp.storage_bits)
    payload = tw["payload"]
    np.testing.assert_array_equal(payload.scales.numpy(), np.asarray(js))
    for x, y in zip(tree_leaves(payload.levels), jax.tree.leaves(jpacked)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(tw["bits"].numpy(), np.asarray(jw["bits"]))
    np.testing.assert_array_equal(tw["unit_bytes"].numpy(),
                                  np.asarray(jw["unit_bytes"]))
    assert tw["nbytes"] == jw["nbytes"]

    for x, y in zip(tree_leaves(params_to_numpy(tnew)),
                    jax.tree.leaves(jnew)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=EQUIV_TOL)
    assert (trows is None) == (jrows is None)
    if jrows is not None:
        for x, y in zip(tree_leaves(params_to_numpy(trows)),
                        jax.tree.leaves(jrows)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=1e-6)
    tcomm = tstrat.comm_profile(tsel, tumap,
                                unit_bytes_override=tw["unit_bytes"])
    jcomm = jstrat.comm_profile(jsel, jumap,
                                unit_bytes_override=jw["unit_bytes"])
    _assert_comm_equal_to_f32(tcomm, jcomm)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_compressed_round_matches_reference(params, round_inputs, setting):
    """One whole vmap round through build_round_fn, residual rows injected
    through the state seam: identical selection, params within 2e-5 plus
    one quantization step, residual rows likewise."""
    jp, tp = params
    inp = round_inputs
    jfl = _fl(JFLConfig, jwire.CompressionConfig, setting)
    tfl = _fl(TFLConfig, CompressionConfig, setting)
    jumap, tumap = JUnitMap.build(jp), TUnitMap.build(tp)
    state = None
    if tfl.compression.error_feedback:
        rng = np.random.default_rng(3)
        state = {"client": {"residual": jax.tree.map(
            lambda l: (1e-3 * rng.normal(size=(K,) + l.shape))
            .astype(np.float32), jp)}}
    jnew, jm = jax.jit(jbuild(_jloss, jumap, jfl))(
        jp, {k: jnp.asarray(inp[k]) for k in ("images", "labels")},
        jnp.asarray(inp["sizes"]), jax.random.PRNGKey(0),
        None if state is None else jax.tree.map(jnp.asarray, state))
    tnew, tm = tbuild(_tloss, tumap, tfl)(
        tp, {k: torch.from_numpy(inp[k]) for k in ("images", "labels")},
        torch.from_numpy(inp["sizes"]), state_from_numpy(state, "cpu"))
    np.testing.assert_array_equal(tm["selection"].numpy(),
                                  np.asarray(jm["selection"]))
    step = tm["wire"]["payload"].scales.amax(dim=0).numpy()
    _assert_close_per_unit(tnew, jnew, tumap, step)
    if state is not None:
        trows = state_to_numpy(tm["state"])["client"]["residual"]
        for u, x, y in zip(_unit_of_leaves(tumap, tp),
                           jax.tree.leaves(trows),
                           jax.tree.leaves(jm["state"]["client"]["residual"])):
            np.testing.assert_allclose(x, np.asarray(y), rtol=0,
                                       atol=1e-6 + float(step[u]))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               atol=EQUIV_TOL, rtol=0)
    _assert_comm_equal_to_f32(tm["comm"], jm["comm"])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_run_training_compressed_matches_reference(params, setting,
                                                   monkeypatch):
    """3 rounds of run_training(sampler="host"), seed 0: equal comm,
    params and the final residual store within 2e-5 plus one quantization
    step of their unit (the largest scale any round used).

    The step is needed: after local training the two packages' locals are
    a last bit apart, and with int8 levels an element can sit on either
    side of a .5 boundary, so one level flips (run
    tests/test_torch_loss_trajectory.py with ``--bits 8 --ef`` for the
    paper's K=20). The losses, taken at those params, agree to a relative
    1e-5."""
    jp, tp = params
    jtrain, _ = jdata.make_image_dataset(num_train=400, num_test=16, seed=2)
    ttrain, _ = tdata.make_image_dataset(num_train=400, num_test=16, seed=2)
    jd = jdata.FederatedData(jtrain.xs, jtrain.ys,
                             jdata.iid_partition(jtrain.ys, N, seed=0))
    td = tdata.FederatedData(ttrain.xs, ttrain.ys,
                             tdata.iid_partition(ttrain.ys, N, seed=0))
    steps = []
    packed_reduce = QuantizedUpload._packed_reduce

    def recording(self, *a, **kw):
        out = packed_reduce(self, *a, **kw)
        steps.append(out[3]["payload"].scales.amax(dim=0))
        return out

    monkeypatch.setattr(QuantizedUpload, "_packed_reduce", recording)
    jparams, jlog = jrun(jp, _jloss, jd,
                         _fl(JFLConfig, jwire.CompressionConfig, setting),
                         rounds=3, seed=0, sampler="host")
    tparams, tlog = trun(tp, _tloss, td,
                         _fl(TFLConfig, CompressionConfig, setting),
                         rounds=3, seed=0, sampler="host", device="cpu")
    assert len(steps) == 3
    step = torch.stack(steps).amax(dim=0).numpy()
    tumap = TUnitMap.build(tp)
    _assert_close_per_unit(tparams, jparams, tumap, step)
    # a round's loss is taken at params that may differ by one step
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=EQUIV_TOL,
                               rtol=1e-5)
    assert tlog.meter.uplink_bytes == jlog.meter.uplink_bytes
    assert tlog.uplink_mb == jlog.uplink_mb
    if SETTINGS[setting]["error_feedback"]:
        tstore = state_to_numpy(tlog.final_state)["client"]["residual"]
        jstore = jlog.final_state["client"]["residual"]
        for u, x, y in zip(_unit_of_leaves(tumap, tp),
                           jax.tree.leaves(tstore), jax.tree.leaves(jstore)):
            assert x.shape == (N,) + x.shape[1:]
            np.testing.assert_allclose(x, np.asarray(y), rtol=0,
                                       atol=1e-6 + float(step[u]))
    else:
        assert tlog.final_state is None and jlog.final_state is None


@pytest.mark.parametrize("ef", [False, True], ids=["noef", "ef"])
def test_packed_matches_legacy_chain(params, ef):
    """As tests/test_wire.py::test_fused_trajectory_matches_legacy: the
    packed path and the legacy chain agree to f32 summation order over 3
    rounds (relative L2 < 1e-4), with identical selection.

    Batch seed 101: with seed 100 the two paths' f32 summation orders
    flip one int8 level in round 2 and the relative L2 passes 1e-4 by
    round 3."""
    _, tp = params
    umap = TUnitMap.build(tp)

    def fl(fused):
        return TFLConfig(algo="fedldf", num_clients=4, clients_per_round=4,
                         top_n=2, compression=CompressionConfig(
                             bits=8, error_feedback=ef, fused=fused))

    cf, cl = fl(True), fl(False)
    rf, rl = tbuild(_tloss, umap, cf), tbuild(_tloss, umap, cl)
    sf = tmake_strategy(cf).init_state(tp, 4)
    sl = tmake_strategy(cl).init_state(tp, 4)
    pf = pl = tp
    rng = np.random.default_rng(101)
    for _ in range(3):
        batch = {"images": torch.from_numpy(rng.normal(
            size=(4, 8, 32, 32, 3)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(
                     0, 10, size=(4, 8)).astype(np.int64))}
        pf, mf = rf(pf, batch, torch.ones(4), sf)
        pl, ml = rl(pl, batch, torch.ones(4), sl)
        sf, sl = mf.get("state", sf), ml.get("state", sl)
        num = sum(float(((x - y) ** 2).sum())
                  for x, y in zip(tree_leaves(pf), tree_leaves(pl)))
        den = sum(float((x ** 2).sum()) for x in tree_leaves(pf))
        assert (num / den) ** 0.5 < 1e-4
        assert torch.equal(mf["selection"], ml["selection"])
    assert float(mf["comm"]["savings_frac"]) == pytest.approx(
        float(ml["comm"]["savings_frac"]), abs=0.01)


def test_scan_refuses_compression_with_the_reference_message():
    msg = jserver._SCAN_COMPRESSION_MSG
    with pytest.raises(NotImplementedError) as jerr:
        JFLConfig(mode="scan", compression=jwire.CompressionConfig())
    with pytest.raises(NotImplementedError) as terr:
        TFLConfig(mode="scan", compression=CompressionConfig())
    assert str(terr.value) == str(jerr.value) == msg
    with pytest.raises(NotImplementedError) as terr:
        tbuild_scan(_tloss, None, TFLConfig(compression=CompressionConfig()))
    assert str(terr.value) == msg


def test_compression_config_refusals(params):
    with pytest.raises(TypeError, match="CompressionConfig"):
        TFLConfig(compression={"bits": 8})
    _, tp = params
    fl = TFLConfig(num_clients=N, clients_per_round=K, top_n=TOP_N,
                   compression=CompressionConfig(error_feedback=True))
    batch = {"images": torch.zeros(K, 2, 32, 32, 3),
             "labels": torch.zeros(K, 2, dtype=torch.int64)}
    with pytest.raises(ValueError, match="residual rows"):
        tbuild(_tloss, TUnitMap.build(tp), fl)(tp, batch, torch.ones(K))


def test_fl_config_passes_compression_through():
    comp = CompressionConfig(bits=4)
    assert tvgg9.fl_config(compression=comp).compression is comp
    assert tvgg9.fl_config().compression is None
    strat = tmake_strategy(tvgg9.fl_config(compression=comp))
    assert isinstance(strat, QuantizedUpload) and strat.packed_upload
    assert strat.name == "fedldf+q4" and strat.needs_divergence
