"""The packed uplink's pieces against the reference: the plain fused uplink
kernels vs ``repro.kernels.ref``, the wire format (quantization, nibble
packing, byte accounting, bit allocation, ``CompressionConfig``), the
legacy unfused chain, and the small core helpers the compressed round
uses. The CUDA kernels are held to the plain versions on the card in
tests/test_torch_gpu.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import UnitMap as JUnitMap  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import vgg9_cifar10 as tvgg9  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.core.units import UnitMap as TUnitMap  # noqa: E402
from repro_torch.federated import make_strategy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import uplink as tku  # noqa: E402
from repro_torch.launch.sharding import init_residual_store  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

TOL = {"rtol": 3e-5, "atol": 1e-5}        # tests/test_wire.py:187,206
UPLINK_SHAPES = [(1, 1, 1), (3, 7, 129), (4, 16, 2048), (5, 33, 2049)]
UPLINK_EF_SHAPES = [(2, 5, 64), (4, 16, 2048), (3, 9, 515)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CFG = jcnn.VGGConfig().reduced()


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


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()


@pytest.fixture(scope="module")
def model():
    """Reduced VGG-9 params, a perturbed local model and both unit maps."""
    jp = _np_params(CFG, 0)
    rng = np.random.default_rng(3)
    local = jax.tree.map(
        lambda l: (l + 0.01 * rng.normal(size=l.shape)).astype(np.float32),
        jp)
    return jp, local, JUnitMap.build(jp), TUnitMap.build(
        params_from_numpy(jp, "cpu"))


def _uplink_inputs(shape, seed):
    k, r, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, size=shape).astype(np.int8),
            rng.uniform(1e-4, 1.0, size=(k, r)).astype(np.float32),
            rng.uniform(0.0, 1.0, size=(k, r)).astype(np.float32))


@pytest.mark.parametrize("shape", UPLINK_SHAPES)
def test_fused_uplink_plain_matches_reference(shape):
    lv, s, w = _uplink_inputs(shape, sum(shape))
    out = ops.fused_uplink(*map(torch.from_numpy, (lv, s, w)))
    assert out.shape == shape[1:] and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jref.fused_uplink(
        jnp.asarray(lv), jnp.asarray(s), jnp.asarray(w)), **TOL)
    assert ops.launch_counts()["fused_uplink"] == 0


@pytest.mark.parametrize("shape", UPLINK_EF_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_uplink_ef_plain_matches_reference(shape, dtype):
    lv, s, w = _uplink_inputs(shape, shape[2])
    rng = np.random.default_rng(shape[2] + 1)
    gate = (rng.uniform(size=shape[:2]) < 0.5).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    v32 = rng.normal(size=shape).astype(np.float32)
    e32 = rng.normal(size=shape).astype(np.float32)
    jv, je = jnp.asarray(v32).astype(jdt), jnp.asarray(e32).astype(jdt)
    tv, te = torch.from_numpy(v32).to(tdt), torch.from_numpy(e32).to(tdt)
    num, res = ops.fused_uplink_ef(*map(torch.from_numpy, (lv, s, w, gate)),
                                   tv, te)
    enum, eres = jref.fused_uplink_ef(jnp.asarray(lv), jnp.asarray(s),
                                      jnp.asarray(w), jnp.asarray(gate), jv,
                                      je)
    np.testing.assert_allclose(num.numpy(), enum, **TOL)
    np.testing.assert_allclose(res.numpy(), eres, **TOL)
    # EF residual gating: unselected rows keep e_old exactly
    off = gate == 0.0
    np.testing.assert_array_equal(res.numpy()[off], te.float().numpy()[off])
    assert ops.launch_counts()["fused_uplink_ef"] == 0


@pytest.mark.parametrize("launch", [
    lambda t, i: tku.fused_uplink(i, t[:, :, 0].contiguous(),
                                  t[:, :, 0].contiguous()),
    lambda t, i: tku.fused_uplink_ef(i, *([t[:, :, 0].contiguous()] * 3), t,
                                     t),
], ids=["fused_uplink", "fused_uplink_ef"])
def test_uplink_launchers_refuse_cpu_tensors(launch):
    """The CUDA launchers never fall back: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.ones(2, 3, 8), torch.ones(2, 3, 8, dtype=torch.int8))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# ----------------------------------------------------------------------
# wire format
# ----------------------------------------------------------------------
def _bits(umap, kind):
    if kind == "random":
        rng = np.random.default_rng(11)
        return rng.integers(2, 9, size=umap.num_units).astype(np.float32)
    return np.full(umap.num_units, float(kind), np.float32)


@pytest.mark.parametrize("bits", [8, 4, "random"])
def test_quantize_units_bit_identical(model, bits):
    jp, local, jumap, tumap = model
    delta = jax.tree.map(lambda a, b: a - b, local, jp)
    b = _bits(jumap, bits)
    jlv, js = jwire.quantize_units(jax.tree.map(jnp.asarray, delta), jumap,
                                   jnp.asarray(b))
    tlv, ts = twire.quantize_units(params_from_numpy(delta, "cpu"), tumap,
                                   torch.from_numpy(b))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for x, y in zip(jax.tree.leaves(params_to_numpy(tlv)),
                    jax.tree.leaves(jlv)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_quantize_units_stacked_equals_per_client(model):
    """The client-stacked call equals K separate calls (the reference runs
    its quantizer under jax.vmap)."""
    jp, local, jumap, tumap = model
    rng = np.random.default_rng(4)
    stacked = jax.tree.map(
        lambda l: rng.normal(size=(3,) + l.shape).astype(np.float32), jp)
    b = _bits(jumap, "random")
    jlv, js = jax.vmap(lambda d: jwire.quantize_units(d, jumap,
                                                      jnp.asarray(b)))(
        jax.tree.map(jnp.asarray, stacked))
    tlv, ts = twire.quantize_units(params_from_numpy(stacked, "cpu"), tumap,
                                   torch.from_numpy(b), stacked=True)
    assert ts.shape == (3, jumap.num_units)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for x, y in zip(jax.tree.leaves(params_to_numpy(tlv)),
                    jax.tree.leaves(jlv)):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("storage_bits,bits", [(8, 8), (8, 5), (4, 4),
                                               (4, 2)])
def test_pack_unpack_byte_identical(model, storage_bits, bits):
    jp, local, jumap, tumap = model
    delta = jax.tree.map(lambda a, b: a - b, local, jp)
    b = _bits(jumap, bits)
    jpay = jwire.pack(jax.tree.map(jnp.asarray, delta), jumap,
                      jnp.asarray(b), storage_bits=storage_bits)
    tdelta = params_from_numpy(delta, "cpu")
    tpay = twire.pack(tdelta, tumap, torch.from_numpy(b),
                      storage_bits=storage_bits)
    for x, y in zip(jax.tree.leaves(params_to_numpy(tpay.levels)),
                    jax.tree.leaves(jpay.levels)):
        assert x.dtype == np.int8
        np.testing.assert_array_equal(x, np.asarray(y))
    for x, y in zip(jax.tree.leaves(params_to_numpy(
            twire.unpack_levels(tpay, tdelta))),
            jax.tree.leaves(jwire.unpack_levels(jpay, delta))):
        np.testing.assert_array_equal(x, np.asarray(y))
    for x, y in zip(jax.tree.leaves(params_to_numpy(
            twire.dequantize(tpay, tumap, tdelta))),
            jax.tree.leaves(jwire.dequantize(jpay, jumap, delta))):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert tpay.nbytes == jpay.nbytes
    np.testing.assert_array_equal(tpay.unit_wire_bytes(tumap).numpy(),
                                  np.asarray(jpay.unit_wire_bytes(jumap)))


@pytest.mark.parametrize("shape", [(3, 5), (2, 1), (4, 6), (2, 3, 7)])
def test_pack4_odd_tail_byte_identical(shape):
    """As tests/test_wire.py::test_pack4_odd_tail, plus the buffer bytes."""
    x = np.arange(int(np.prod(shape))).reshape(shape) % 15 - 7
    x = x.astype(np.int8)
    tp = twire._pack4(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(jwire._pack4(jnp.asarray(x))))
    np.testing.assert_array_equal(
        twire._unpack4(tp, shape[-1]).numpy(), x)


@pytest.mark.parametrize("divs_kind", ["matrix", "vector", "uniform"])
@pytest.mark.parametrize("avg_bits,lo,hi", [(4.0, 2, 8), (3.0, 2, 4),
                                            (6.5, 1, 8)])
def test_allocate_bits_matches_reference(model, divs_kind, avg_bits, lo, hi):
    _, _, jumap, tumap = model
    rng = np.random.default_rng(5)
    u = jumap.num_units
    if divs_kind == "matrix":
        d = rng.uniform(0.01, 3.0, size=(6, u)).astype(np.float32)
    elif divs_kind == "vector":
        d = rng.uniform(0.01, 3.0, size=u).astype(np.float32)
    else:   # equal divergence per parameter: every unit gets avg_bits
        d = np.sqrt(np.asarray(jumap.unit_params, np.float32))
    want = jwire.allocate_bits(jnp.asarray(d), jumap, avg_bits=avg_bits,
                               min_bits=lo, max_bits=hi)
    got = twire.allocate_bits(torch.from_numpy(d), tumap, avg_bits=avg_bits,
                              min_bits=lo, max_bits=hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs", [
    {"bits": 1}, {"bits": 9}, {"bits": "fast"}, {"allocation": "greedy"},
    {"min_bits": 0}, {"min_bits": 6, "max_bits": 4}, {"max_bits": 9},
    {"bits": "auto", "avg_bits": 9.0}, {"bits": "auto", "fused": False},
])
def test_compression_config_validation_matches_reference(kwargs):
    with pytest.raises(Exception) as jerr:
        jwire.CompressionConfig(**kwargs)
    with pytest.raises(type(jerr.value)) as terr:
        twire.CompressionConfig(**kwargs)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kwargs", [{}, {"bits": 4, "error_feedback": True},
                                    {"bits": "auto", "max_bits": 4},
                                    {"bits": 3, "fused": False}])
def test_compression_config_fields_and_storage(model, kwargs):
    _, _, jumap, tumap = model
    jc, tc = jwire.CompressionConfig(**kwargs), twire.CompressionConfig(
        **kwargs)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.is_auto, tc.storage_bits) == (jc.is_auto, jc.storage_bits)
    if not tc.is_auto:
        np.testing.assert_array_equal(tc.bits_vector(tumap).numpy(),
                                      np.asarray(jc.bits_vector(jumap)))


# ----------------------------------------------------------------------
# legacy chain and core helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_upload_matches_reference(model, bits, with_residual):
    jp, local, jumap, tumap = model
    rng = np.random.default_rng(6)
    res = (jax.tree.map(lambda l: 1e-3 * rng.normal(size=l.shape).astype(
        np.float32), jp) if with_residual else None)
    jhat, jres = jcompress.compress_upload(
        jax.tree.map(jnp.asarray, local), jax.tree.map(jnp.asarray, jp),
        jumap, bits, None if res is None else jax.tree.map(jnp.asarray, res))
    that, tres = tcompress.compress_upload(
        params_from_numpy(local, "cpu"), params_from_numpy(jp, "cpu"), tumap,
        bits, None if res is None else params_from_numpy(res, "cpu"))
    for got, want in ((that, jhat), (tres, jres)):
        for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_expand_to_leaves_matches_reference(model):
    jp, _, jumap, tumap = model
    per_unit = np.arange(1, jumap.num_units + 1, dtype=np.float32)
    want = jumap.expand_to_leaves(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(per_unit))
    got = tumap.expand_to_leaves(params_from_numpy(jp, "cpu"),
                                 torch.from_numpy(per_unit))
    for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("override", ["param", "unit"])
def test_round_comm_overrides_match_reference(model, override):
    _, _, jumap, tumap = model
    rng = np.random.default_rng(8)
    sel = (rng.random((5, jumap.num_units)) < 0.4).astype(np.float32)
    if override == "param":
        jkw = tkw = {"param_bytes_override": 0.5}
    else:
        ub = rng.integers(10, 5000, size=jumap.num_units).astype(np.float32)
        jkw = {"unit_bytes_override": jnp.asarray(ub)}
        tkw = {"unit_bytes_override": torch.from_numpy(ub)}
    want = jcomm.round_comm(jnp.asarray(sel), jumap, **jkw)
    got = tcomm.round_comm(torch.from_numpy(sel), tumap, **tkw)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("bits,want", [(8, 18_839_724), (4, 9_420_312)])
def test_packed_uplink_bytes_exact_at_full_width(bits, want):
    """n·Σ_u(ceil(p_u·b/8) + 5) + K·U·4 bytes for full-width VGG-9 at K=20,
    n=4, whichever clients are selected. The payload is summed in float64
    and rounded once: in f32 (the spacing is 2 B at 1.9e7) the total
    depends on the order of the sum."""
    params = tcnn.init_params(tcnn.VGGConfig(),
                              torch.Generator().manual_seed(0), "cpu")
    umap = TUnitMap.build(params)
    fl = tvgg9.fl_config(compression=twire.CompressionConfig(bits=bits))
    strat = make_strategy(fl)
    rng = np.random.default_rng(0)
    for _ in range(10):
        sel = np.zeros((fl.clients_per_round, umap.num_units), np.float32)
        for u in range(umap.num_units):
            sel[rng.choice(fl.clients_per_round, fl.top_n,
                           replace=False), u] = 1.0
        comm = strat.comm_profile(torch.from_numpy(sel), umap)
        assert float(comm["uplink_total"]) == want


@pytest.mark.parametrize("dead_unit", [False, True])
def test_stacked_psum_finalize_matches_reference(model, dead_unit):
    jp, local, jumap, tumap = model
    rng = np.random.default_rng(9)
    denom = rng.uniform(1.0, 300.0, size=jumap.num_units).astype(np.float32)
    if dead_unit:
        denom[2] = 0.0
    want = jagg.stacked_psum_finalize(
        jax.tree.map(jnp.asarray, local), jnp.asarray(denom), jumap,
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jp))
    tp = params_from_numpy(jp, "cpu")
    got = tagg.stacked_psum_finalize(params_from_numpy(local, "cpu"),
                                     torch.from_numpy(denom), tumap, tp, tp)
    for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_residual_store_keeps_leaf_dtype(model, dtype):
    jp, _, _, _ = model
    params = {k: {n: v.to(dtype) for n, v in sub.items()}
              for k, sub in params_from_numpy(jp, "cpu").items()}
    store = init_residual_store(params, 7)
    for key, sub in params.items():
        for name, p in sub.items():
            s = store[key][name]
            assert s.shape == (7,) + p.shape and s.dtype == dtype
            assert not s.any()
