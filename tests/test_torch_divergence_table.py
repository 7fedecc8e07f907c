"""The grouped Eq. 3 divergence and the grouped error-feedback uplink, on the
CPU: their plain versions against the per-leaf composition (bit for bit)
and against the reference (its ``UnitMap.sq_divergence`` with the Pallas
``sqdiff_rowsum`` in interpret mode, and its ``fused_uplink_ef`` kernel in
interpret mode), the leaf table's size and plan at the error-feedback
kernel's cap, one grouped call a round on the main path (with the per-leaf
arguments still honoured), the launchers' refusals, and
``stacked_psum_finalize`` without a fallback. The CUDA kernels themselves
are held to the plain versions on the card in tests/test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import units as jun  # noqa: E402
from repro.kernels import divergence as jkd  # noqa: E402
from repro.kernels import uplink as jku  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import units as tun  # noqa: E402
from repro_torch.federated import (CompressionConfig, FLConfig,  # noqa: E402
                                   build_round_fn, make_strategy)
from repro_torch.kernels import _leaves, ops, ref  # noqa: E402
from repro_torch.kernels import divergence as tkd  # noqa: E402
from repro_torch.kernels import uplink as tku  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]                  # tests/test_kernels.py:18
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"rtol": 3e-3, "atol": 1e-5}              # tests/test_kernels.py:33,45
UPLINK_TOL = {"rtol": 3e-5, "atol": 1e-5}       # tests/test_wire.py:187,206
# full-width VGG-9's leaves in tree order, as (rows, cols) of one unit row
VGG9 = [(1, int(np.prod(s.shape))) for s in jax.tree.leaves(jax.eval_shape(
    lambda: jcnn.init_params(jax.random.PRNGKey(0), jcnn.VGGConfig())))]


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()


def _reduced_shapes():
    return jax.eval_shape(lambda: jcnn.init_params(
        jax.random.PRNGKey(0), jcnn.VGGConfig().reduced()))


def _toy_stacked(rng, lead=()):
    """A stacked 'blocks' subtree (L = 3 units, n > 1) beside plain units
    (tests/test_torch_units.py)."""
    shapes = {"blocks": {"w": (3, 4, 5), "b": (3, 5)},
              "embed": {"table": (7, 4)}, "head": {"w": (4, 2)}}
    return {k: {n: rng.normal(size=lead + s).astype(np.float32)
                for n, s in sub.items()} for k, sub in shapes.items()}


def _trees(tree_kind, k, rng):
    """(ref, locals) numpy trees; locals carry a leading K unless k is
    None."""
    lead = () if k is None else (k,)
    if tree_kind == "vgg_reduced":
        shapes = _reduced_shapes()
        return [jax.tree.map(lambda s, lead=lead: rng.normal(
            size=lead + s.shape).astype(np.float32), shapes)
                for lead in ((), lead)]
    return _toy_stacked(rng), _toy_stacked(rng, lead)


def _pallas_rowsum(a, b):
    return jkd.sqdiff_rowsum(a, b, interpret=True)


# ----------------------------------------------------------------------
# sqdiff_rowsum_leaves: the plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tree_kind", ["vgg_reduced", "stacked"])
@pytest.mark.parametrize("k", [5, None], ids=["K=5", "single"])
def test_sqdiff_rowsum_leaves_plain_matches_per_leaf_and_reference(
        tree_kind, k):
    """UnitMap.sq_divergence's one grouped call equals its per-leaf
    composition bit for bit, and the reference's UnitMap.sq_divergence
    through the Pallas kernel (interpret mode), client by client, at the
    tolerance tests/test_torch_units.py uses."""
    rng = np.random.default_rng(21)
    ref_np, loc_np = _trees(tree_kind, k, rng)
    tref, tloc = (params_from_numpy(ref_np, "cpu"),
                  params_from_numpy(loc_np, "cpu"))
    tu = tun.UnitMap.build(tref)
    grouped = tu.sq_divergence(tloc, tref)
    per_leaf = tu.sq_divergence(tloc, tref, sqdiff_rowsum=ref.sqdiff_rowsum)
    assert grouped.dtype == torch.float32
    assert grouped.shape == ((tu.num_units,) if k is None
                             else (k, tu.num_units))
    assert torch.equal(grouped, per_leaf)
    ju = jun.UnitMap.build(ref_np)
    jref_p = jax.tree.map(jnp.asarray, ref_np)
    clients = [loc_np] if k is None else [jax.tree.map(
        lambda l, i=i: l[i], loc_np) for i in range(k)]
    want = np.stack([np.asarray(ju.sq_divergence(
        jax.tree.map(jnp.asarray, c), jref_p, sqdiff_rowsum=_pallas_rowsum))
        for c in clients])
    np.testing.assert_allclose(grouped.reshape(len(clients), -1).numpy(),
                               want, **TOL)
    assert ops.launch_counts()["sqdiff_rowsum"] == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sqdiff_rowsum_leaves_plain_on_reference_shapes(dtype):
    """SHAPES as one-entry tables and as one mixed table at K = 2 (each
    leaf's rows its own units; several leaves share unit 0), against the
    per-leaf composition in list order from 0 and the Pallas kernel."""
    rng = np.random.default_rng(22)
    jdt, tdt = DTYPES[dtype]
    kk, a_np, b_np, units = 2, [], [], []
    off = 0
    for i, (r, c) in enumerate(SHAPES):
        a_np.append(rng.normal(size=(kk * r, c)).astype(np.float32))
        b_np.append(rng.normal(size=(r, c)).astype(np.float32))
        units.append((0 if i < 2 else off, r))     # two leaves on unit 0
        off = units[-1][0] + r
    a = [torch.from_numpy(x).to(tdt) for x in a_np]
    b = [torch.from_numpy(y).to(tdt) for y in b_np]
    for x, y in zip(a, b):                             # one-entry tables
        one = ops.sqdiff_rowsum_leaves([x], [y], [(0, y.shape[0])])
        assert torch.equal(one.reshape(-1), ref.sqdiff_rowsum(x, y))
    got = ops.sqdiff_rowsum_leaves(a, b, units)
    want = torch.zeros(got.shape)
    for x, y, (o, n) in zip(a, b, units):
        want[:, o:o + n] = want[:, o:o + n] + ref.sqdiff_rowsum(
            x, y).reshape(kk, n)
    assert got.shape == (kk, off) and torch.equal(got, want)
    jwant = np.zeros(got.shape, np.float32)
    for x, y, (o, n) in zip(a_np, b_np, units):
        jx, jy = jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)
        rows = _pallas_rowsum(jx, jnp.tile(jy, (kk, 1)))
        jwant[:, o:o + n] += np.asarray(rows).reshape(kk, n)
    np.testing.assert_allclose(got.numpy(), jwant, **TOL)


def test_sqdiff_rowsum_leaves_unit_sums_add_leaves_in_list_order():
    """Three leaves of one unit whose row sums are 1, 2**-24 and 2**-24:
    ((0 + 1) + 2**-24) + 2**-24 rounds to 1 in f32, any other order (or a
    tree) does not."""
    a = [torch.ones(1, 1), torch.full((1, 1), 2.0 ** -12),
         torch.full((1, 1), 2.0 ** -12)]
    b = [torch.zeros(1, 1)] * 3
    got = ops.sqdiff_rowsum_leaves(a, b, [(0, 1)] * 3)
    assert got.item() == 1.0
    rev = ops.sqdiff_rowsum_leaves(a[::-1], b, [(0, 1)] * 3)
    assert rev.item() == np.float32(1.0) + np.float32(2.0 ** -23)


# ----------------------------------------------------------------------
# fused_uplink_ef_leaves: the plain version
# ----------------------------------------------------------------------
def _ef_table(rng, kk, shapes, jdt, tdt):
    """(levels, v, e_old) a leaf of (K, n, C) and the shared (K, U) scales,
    w and gate; leaf i's rows are units off_i .. off_i + n_i - 1."""
    units, off = [], 0
    for n, _ in shapes:
        units.append((off, n))
        off += n
    scales = rng.uniform(1e-4, 1.0, size=(kk, off)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(kk, off)).astype(np.float32)
    gate = (rng.uniform(size=(kk, off)) < 0.5).astype(np.float32)
    w[gate == 0] = 0.0                       # as unit_weights(selection)
    leaves = []
    for n, c in shapes:
        lv = rng.integers(-127, 128, size=(kk, n, c)).astype(np.int8)
        v = rng.normal(size=(kk, n, c)).astype(np.float32)
        e = rng.normal(size=(kk, n, c)).astype(np.float32)
        leaves.append((lv, v, e))
    t = ([torch.from_numpy(lv) for lv, _, _ in leaves],
         [torch.from_numpy(v).to(tdt) for _, v, _ in leaves],
         [torch.from_numpy(e).to(tdt) for _, _, e in leaves], units,
         *map(torch.from_numpy, (scales, w, gate)))
    j = [(jnp.asarray(lv), jnp.asarray(v).astype(jdt),
          jnp.asarray(e).astype(jdt)) for lv, v, e in leaves]
    return t, j, (scales, w, gate)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_uplink_ef_leaves_plain_matches_per_leaf_and_reference(dtype):
    rng = np.random.default_rng(23)
    jdt, tdt = DTYPES[dtype]
    shapes = [(1, 1), (5, 64), (2, 515), (1, 10), (3, 2049)]
    (lvs, vs, es, units, s, w, g), jleaves, (sn, wn, gn) = _ef_table(
        rng, 3, shapes, jdt, tdt)
    got = ops.fused_uplink_ef_leaves(lvs, vs, es, units, s, w, g)
    assert len(got) == len(shapes)
    for (num, res), lv, v, e, (off, n), (jl, jv, je) in zip(
            got, lvs, vs, es, units, jleaves):
        assert num.shape == lv.shape[1:] and res.shape == lv.shape
        assert num.dtype == res.dtype == torch.float32
        seg = [t[:, off:off + n] for t in (s, w, g)]
        want_num, want_res = ref.fused_uplink_ef(lv, *seg, v, e)
        assert torch.equal(num, want_num) and torch.equal(res, want_res)
        jseg = [jnp.asarray(t[:, off:off + n]) for t in (sn, wn, gn)]
        jnum, jres = jku.fused_uplink_ef(jl, *jseg, jv, je, interpret=True)
        np.testing.assert_allclose(num.numpy(), jnum, **UPLINK_TOL)
        np.testing.assert_allclose(res.numpy(), jres, **UPLINK_TOL)
        off_rows = seg[2] == 0                        # gate == 0 keeps e
        assert torch.equal(res[off_rows], e.float()[off_rows])
    assert ops.launch_counts()["fused_uplink_ef"] == 0


def test_grouped_plain_versions_refuse_unequal_lists():
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        ref.sqdiff_rowsum_leaves([a, a], [a], [(0, 2)] * 2)
    with pytest.raises(ValueError):
        ref.sqdiff_rowsum_leaves([], [], [])
    with pytest.raises(ValueError):
        ref.fused_uplink_ef_leaves([torch.zeros(2, 1, 3, dtype=torch.int8)],
                                   [], [], [], a, a, a)


# ----------------------------------------------------------------------
# the leaf table at the error-feedback kernel's cap
# ----------------------------------------------------------------------
def test_table_bytes_fit_the_parameter_space():
    """leaf_table::TableOf<P> for the kernels' pointer counts (2 for the
    divergence, 4 for the accumulate and the uplink, 5 for the EF uplink)
    fits 4 KB of kernel parameters with a few scalars, at 48 leaves."""
    assert _leaves.MAX_POINTERS == 5 and _leaves.MAX_LEAVES == 48
    assert _leaves.table_bytes(5) == 3176
    for p in (2, 4, 5):
        assert _leaves.table_bytes(p) + 64 <= _leaves.PARAM_BYTES
        assert _leaves.table_bytes(p, 1) < _leaves.table_bytes(p)
    assert _leaves.table_bytes(6, 64) + 64 > _leaves.PARAM_BYTES


def test_ef_planner_on_full_vgg9():
    """The EF kernel's widths are 8 and 4 columns a thread: 33 of VGG-9's
    leaves take 8, fc.b (10 columns) 1; all 34 go in one launch, a block
    per 2048 columns of a row."""
    widths = [_leaves.vector_width(c, ((0, 1), (64, 4), (128, 2), (256, 4)),
                                   tku.EF_WIDTHS) for _, c in VGG9]
    assert widths.count(8) == 33 and widths.count(1) == 1
    blocks = [_leaves.leaf_blocks(r, c, w, per_row=True)
              for (r, c), w in zip(VGG9, widths)]
    assert max(blocks) == 2359296 // 2048
    chunks = _leaves.plan(blocks)
    assert len(chunks) == 1 and chunks[0].n == 34
    assert chunks[0].starts[-1] == sum(blocks)


@pytest.mark.parametrize("cols,operands,want", [
    (4096, ((0, 1), (16, 4), (32, 2), (48, 4)), 8),
    (4100, ((0, 1), (16, 4)), 4),                # a multiple of 4, not 8
    (4096, ((4, 1), (16, 4)), 4),                # levels 4 bytes off 8
    (4096, ((0, 1), (8, 4)), 1),                 # f32 v 8 bytes off 16
    (4096, ((0, 1), (8, 2)), 4),                 # bf16 v 8 bytes off 16
])
def test_ef_vector_width(cols, operands, want):
    assert _leaves.vector_width(cols, operands, tku.EF_WIDTHS) == want


@pytest.mark.parametrize("n,want", [(34, [34]), (48, [48]), (49, [48, 1]),
                                    (100, [48, 48, 4])])
def test_planner_cuts_at_the_ef_cap(n, want):
    blocks = [1 + i % 7 for i in range(n)]
    assert [c.n for c in _leaves.plan(blocks)] == want


# ----------------------------------------------------------------------
# the main path: one grouped call, or the per-leaf arguments
# ----------------------------------------------------------------------
def _recorder(monkeypatch, name):
    calls = []
    plain = getattr(ops, name)

    def run(*args):
        calls.append(len(args[0]))
        return plain(*args)
    monkeypatch.setattr(ops, name, run)
    return calls


@pytest.mark.parametrize("tree_kind", ["vgg_reduced", "stacked"])
def test_sq_divergence_makes_one_grouped_call(monkeypatch, tree_kind):
    rng = np.random.default_rng(24)
    ref_np, loc_np = _trees(tree_kind, 3, rng)
    tref, tloc = (params_from_numpy(ref_np, "cpu"),
                  params_from_numpy(loc_np, "cpu"))
    tu = tun.UnitMap.build(tref)
    grouped = _recorder(monkeypatch, "sqdiff_rowsum_leaves")
    n_leaves = len(tun.tree_leaves(tref))
    tu.divergence(tloc, tref)
    assert grouped == [n_leaves]
    per_leaf = []

    def rowsum(a, b):
        per_leaf.append(a.shape)
        return ref.sqdiff_rowsum(a, b)
    tu.divergence(tloc, tref, sqdiff_rowsum=rowsum)
    assert grouped == [n_leaves] and len(per_leaf) == n_leaves


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_rounds_call_the_grouped_divergence_once_a_round_or_client(
        monkeypatch, mode):
    """A vmap round makes one grouped Eq. 3 call for its K clients; a scan
    round one a client."""
    cfg = tcnn.VGGConfig().reduced()
    params = tcnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    k = 3
    batch = {"images": torch.from_numpy(rng.normal(
        size=(k, 4, 32, 32, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(
            0, 10, size=(k, 4)).astype(np.int32))}
    fl = FLConfig(num_clients=6, clients_per_round=k, top_n=1, mode=mode,
                  batch_per_client=4)
    umap = tun.UnitMap.build(params)
    round_fn = build_round_fn(lambda p, b: tcnn.classify_loss(p, cfg, b),
                              umap, fl)
    grouped = _recorder(monkeypatch, "sqdiff_rowsum_leaves")
    round_fn(params, batch, torch.tensor([10.0, 20.0, 30.0]))
    n_leaves = len(tun.tree_leaves(params))
    assert grouped == [n_leaves] * (1 if mode == "vmap" else k)


@pytest.fixture
def packed_round():
    rng = np.random.default_rng(25)
    k = 5
    g_np = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                        _reduced_shapes())
    gp = params_from_numpy(g_np, "cpu")
    umap = tun.UnitMap.build(gp)
    locals_ = params_from_numpy(jax.tree.map(
        lambda l: (l + 0.02 * rng.normal(size=(k,) + l.shape))
        .astype(np.float32), g_np), "cpu")
    res = params_from_numpy(jax.tree.map(
        lambda l: (1e-3 * rng.normal(size=(k,) + l.shape))
        .astype(np.float32), g_np), "cpu")
    strat = make_strategy(FLConfig(
        algo="fedldf", num_clients=10, clients_per_round=k, top_n=2,
        compression=CompressionConfig(bits=8, error_feedback=True)))
    divs = umap.divergence(locals_, gp)
    sel = torch.zeros_like(divs)
    sel[:2] = 1.0
    sizes = torch.tensor([100.0, 150.0, 80.0, 120.0, 100.0])
    return strat, (locals_, gp, umap, sel, divs, sizes, res)


def test_packed_ef_round_calls_the_grouped_ef_uplink_once(monkeypatch,
                                                          packed_round):
    """Setting A's round makes one fused_uplink_ef_leaves call over every
    leaf, through ops by default or through the ``fused_uplink_ef_leaves=``
    argument; the per-leaf ``fused_uplink_ef=`` gives the same bits."""
    strat, args = packed_round
    n_leaves = len(tun.tree_leaves(args[1]))
    grouped = _recorder(monkeypatch, "fused_uplink_ef_leaves")
    new, rows, _ = strat.uplink_round(*args)
    assert grouped == [n_leaves]
    given = []

    def rec(*a):
        given.append(len(a[0]))
        return ref.fused_uplink_ef_leaves(*a)
    new2, rows2, _ = strat.uplink_round(*args, fused_uplink_ef_leaves=rec)
    assert given == [n_leaves] and grouped == [n_leaves]
    new3, rows3, _ = strat.uplink_round(*args,
                                        fused_uplink_ef=ref.fused_uplink_ef)
    assert grouped == [n_leaves]
    for a, b, c in zip(tun.tree_leaves(new), tun.tree_leaves(new2),
                       tun.tree_leaves(new3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b, c in zip(tun.tree_leaves(rows), tun.tree_leaves(rows2),
                       tun.tree_leaves(rows3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert ops.launch_counts()["fused_uplink_ef"] == 0


# ----------------------------------------------------------------------
# the CUDA launchers refuse what they do not take
# ----------------------------------------------------------------------
@pytest.mark.parametrize("launch", [
    lambda t, i: tkd.sqdiff_rowsum_leaves([t[0]], [t[0, :1]], [(0, 1)]),
    lambda t, i: tku.fused_uplink_ef_leaves(
        [i], [t], [t], [(0, 3)], *([t[:, :, 0].contiguous()] * 3)),
], ids=["sqdiff_rowsum_leaves", "fused_uplink_ef_leaves"])
def test_new_launchers_refuse_cpu_tensors(launch):
    """The CUDA launchers never fall back: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.ones(2, 3, 8), torch.ones(2, 3, 8, dtype=torch.int8))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_new_launchers_refuse_empty_or_unequal_lists():
    a = torch.ones(2, 8)
    with pytest.raises(ValueError):
        tkd.sqdiff_rowsum_leaves([], [], [])
    with pytest.raises(ValueError):
        tkd.sqdiff_rowsum_leaves([a, a], [a], [(0, 2), (0, 2)])
    s = torch.ones(2, 3)
    lv = torch.ones(2, 3, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        tku.fused_uplink_ef_leaves([], [], [], [], s, s, s)
    with pytest.raises(ValueError):
        tku.fused_uplink_ef_leaves([lv, lv], [lv.float()], [lv.float()],
                                   [(0, 3)], s, s, s)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# ----------------------------------------------------------------------
# stacked_psum_finalize without a fallback
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_fallback", [False, True])
def test_stacked_psum_finalize_fallback_none_matches_reference(
        with_fallback):
    """The input that used to raise TypeError in the port: ones, a plain
    unit and a stacked subtree of 2 units, denominators [2, 0, 1]."""
    tree = {"a": {"w": np.ones((3, 2), np.float32)},
            "blocks": {"w": np.ones((2, 4), np.float32)}}
    fb = jax.tree.map(lambda l: np.full_like(l, 7.0), tree)
    denom = np.array([2.0, 0.0, 1.0], np.float32)
    jt = jax.tree.map(jnp.asarray, tree)
    want = jagg.stacked_psum_finalize(
        jt, jnp.asarray(denom), jun.UnitMap.build(tree), jt,
        jax.tree.map(jnp.asarray, fb) if with_fallback else None)
    tt = params_from_numpy(tree, "cpu")
    got = tagg.stacked_psum_finalize(
        tt, torch.from_numpy(denom), tun.UnitMap.build(tt), tt,
        params_from_numpy(fb, "cpu") if with_fallback else None)
    for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y))
    # unit 1 (blocks row 0) has denominator 0: the fallback, or the
    # numerator divided by 1
    dead = got["blocks"]["w"][0]
    assert bool((dead == (7.0 if with_fallback else 1.0)).all())
