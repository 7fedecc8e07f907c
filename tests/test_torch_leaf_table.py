"""The leaf table, on the CPU: the planner (vector widths, blocks, prefix
sums, chunks) on VGG-9's full-width leaves and on tables longer than one
launch, the grouped plain versions against the reference's jnp oracles and
its Pallas kernels (interpret mode) leaf by leaf, ``UnitMap.accumulate``
(grouped and with a per-leaf callable) against the reference, the packed
uplink's one grouped call a round, and the kernel build's header hashing.
The CUDA kernels themselves are held to the plain versions on the card in
tests/test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import units as jun  # noqa: E402
from repro.kernels import aggregate as jka  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import uplink as jku  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import units as tun  # noqa: E402
from repro_torch.federated import CompressionConfig, FLConfig  # noqa: E402
from repro_torch.federated import make_strategy  # noqa: E402
from repro_torch.kernels import _build, _leaves, ops, ref  # noqa: E402
from repro_torch.kernels import aggregate as tka  # noqa: E402
from repro_torch.kernels import uplink as tku  # noqa: E402

SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]                  # tests/test_kernels.py:18
UPLINK_SHAPES = [(1, 1, 1), (3, 7, 129), (4, 16, 2048), (5, 33, 2049)]
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


# ----------------------------------------------------------------------
# the planner
# ----------------------------------------------------------------------
def test_planner_on_full_vgg9():
    """34 leaves, one launch: every leaf but fc.b (10 columns) takes 16
    elements a thread; blocks are ceil(elements / 4096); the starts are
    their exclusive prefix sum."""
    assert len(VGG9) == 34
    widths = [_leaves.vector_width(c, ((0, 4), (4096, 4), (64, 2)))
              for _, c in VGG9]
    assert widths.count(1) == 1 and widths.count(16) == 33
    assert widths[[c for _, c in VGG9].index(10)] == 1
    for per_row in (False, True):
        blocks = [_leaves.leaf_blocks(r, c, w, per_row)
                  for (r, c), w in zip(VGG9, widths)]
        assert blocks == [-(-c // (256 * w)) for (_, c), w in
                          zip(VGG9, widths)]
        chunks = _leaves.plan(blocks)
        assert len(chunks) == 1 and chunks[0].first == 0
        assert chunks[0].n == 34 and chunks[0].stop == 34
        assert chunks[0].starts == tuple(np.concatenate(
            [[0], np.cumsum(blocks)]).tolist())
        # conv7.w (2,359,296 elements) alone is 576 blocks
        assert max(blocks) == 576 and chunks[0].starts[-1] == sum(blocks)


@pytest.mark.parametrize("n,max_leaves,want", [
    (48, 48, [48]), (49, 48, [48, 1]), (100, 48, [48, 48, 4]),
    (7, 3, [3, 3, 1]),
])
def test_planner_chunks_a_long_table(n, max_leaves, want):
    blocks = [1 + i % 5 for i in range(n)]
    chunks = _leaves.plan(blocks, max_leaves=max_leaves)
    assert [c.n for c in chunks] == want
    assert [c.first for c in chunks] == list(np.cumsum([0] + want[:-1]))
    for c in chunks:
        assert c.starts[0] == 0
        assert np.diff(c.starts).tolist() == blocks[c.first:c.stop]


def test_planner_splits_at_the_grid_limit_and_refuses_bad_leaves():
    assert [c.starts for c in _leaves.plan([5, 5, 5], max_blocks=10)] == \
        [(0, 5, 10), (0, 5)]
    with pytest.raises(ValueError):
        _leaves.plan([3, 11], max_blocks=10)
    with pytest.raises(ValueError):
        _leaves.plan([2, 0])
    assert _leaves.plan([]) == []


@pytest.mark.parametrize("cols,operands,want", [
    (10, ((0, 4), (0, 4)), 1),                  # fc.b: not a multiple of 4
    (4096, ((16, 4), (32, 4), (48, 2)), 16),
    (4100, ((16, 4), (32, 4)), 4),              # a multiple of 4, not 16
    (4096, ((4, 4), (16, 4)), 1),               # f32 view 4 bytes off 16
    (4096, ((16, 4), (8, 2)), 4),               # bf16 8 bytes off 16
    (4096, ((4, 1), (16, 4)), 4),               # int8 levels 4 bytes off
    (4096, ((1, 1), (16, 4)), 1),               # int8 levels 1 byte off
])
def test_vector_width(cols, operands, want):
    assert _leaves.vector_width(cols, operands) == want


def test_vector_width_of_a_misaligned_view():
    base = torch.zeros(4097)
    view, whole = base[1:].view(1, 4096), base[:4096].view(1, 4096)
    assert _leaves.vector_width(4096, ((view.data_ptr(), 4),)) == 1
    assert _leaves.vector_width(4096, ((whole.data_ptr(), 4),)) in (4, 16)


def test_leaf_blocks_flat_and_per_row():
    assert _leaves.leaf_blocks(9, 2049, 1, per_row=False) == 73
    assert _leaves.leaf_blocks(9, 2049, 1, per_row=True) == 81
    assert _leaves.leaf_blocks(62, 32, 16, per_row=False) == 1
    assert _leaves.leaf_blocks(62, 32, 16, per_row=True) == 62


# ----------------------------------------------------------------------
# the grouped plain versions against the reference, leaf by leaf
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_accumulate_leaves_plain_matches_reference(dtype):
    """One table of every SHAPES leaf, in place, against the reference's
    oracle and its Pallas kernel (interpret mode) a leaf."""
    rng = np.random.default_rng(11)
    jdt, tdt = DTYPES[dtype]
    table = [(rng.normal(size=s).astype(np.float32),
              rng.normal(size=s).astype(np.float32),
              rng.normal(size=s[:1]).astype(np.float32)) for s in SHAPES]
    accs = [torch.from_numpy(a.copy()) for a, _, _ in table]
    xs = [torch.from_numpy(x).to(tdt) for _, x, _ in table]
    ws = [torch.from_numpy(w) for _, _, w in table]
    singles = [ref.masked_accumulate(a, x, w) for a, x, w in zip(accs, xs, ws)]
    got = ops.masked_accumulate_leaves(accs, xs, ws)
    assert all(g is a for g, a in zip(got, accs))             # in place
    for out, single, (a, x, w) in zip(accs, singles, table):
        assert torch.equal(out, single)
        ja, jx, jw = jnp.asarray(a), jnp.asarray(x).astype(jdt), jnp.asarray(w)
        np.testing.assert_allclose(out.numpy(),
                                   jref.masked_accumulate(ja, jx, jw), **TOL)
        np.testing.assert_allclose(
            out.numpy(), jka.masked_accumulate(ja, jx, jw, interpret=True),
            **TOL)
    assert ops.launch_counts()["masked_accumulate"] == 0


@pytest.mark.parametrize("zero_rows", [False, True])
def test_fused_uplink_leaves_plain_matches_reference(zero_rows):
    """One table of every uplink shape; with ``zero_rows`` most clients
    weigh 0, as in a fedldf round."""
    rng = np.random.default_rng(12)
    table = []
    for k, r, c in UPLINK_SHAPES:
        w = rng.uniform(0.0, 1.0, size=(k, r)).astype(np.float32)
        if zero_rows:
            w[np.arange(k) % 3 != 0] = 0.0
        table.append((rng.integers(-127, 128, size=(k, r, c)).astype(np.int8),
                      rng.uniform(1e-4, 1.0, size=(k, r)).astype(np.float32),
                      w))
    got = ops.fused_uplink_leaves(*([torch.from_numpy(t[i]) for t in table]
                                    for i in range(3)))
    for out, (lv, s, w) in zip(got, table):
        assert out.shape == lv.shape[1:] and out.dtype == torch.float32
        assert torch.equal(out, ref.fused_uplink(*map(torch.from_numpy,
                                                      (lv, s, w))))
        jargs = tuple(map(jnp.asarray, (lv, s, w)))
        np.testing.assert_allclose(out.numpy(), jref.fused_uplink(*jargs),
                                   **UPLINK_TOL)
        np.testing.assert_allclose(
            out.numpy(), jku.fused_uplink(*jargs, interpret=True),
            **UPLINK_TOL)
    assert ops.launch_counts()["fused_uplink"] == 0


def test_grouped_plain_versions_refuse_unequal_lists():
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        ref.masked_accumulate_leaves([a, a], [a], [torch.zeros(2)] * 2)
    with pytest.raises(ValueError):
        ref.fused_uplink_leaves([torch.zeros(2, 2, 3, dtype=torch.int8)],
                                [], [])


@pytest.mark.parametrize("launch", [
    lambda t, i: tka.masked_accumulate_leaves([t[0]], [t[0]],
                                              [t[0, :, 0].contiguous()]),
    lambda t, i: tku.fused_uplink_leaves([i], [t[:, :, 0].contiguous()],
                                         [t[:, :, 0].contiguous()]),
], ids=["masked_accumulate_leaves", "fused_uplink_leaves"])
def test_grouped_launchers_refuse_cpu_tensors(launch):
    """The CUDA launchers never fall back: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.ones(2, 3, 8), torch.ones(2, 3, 8, dtype=torch.int8))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_grouped_launchers_refuse_empty_or_unequal_lists():
    a = torch.ones(2, 8)
    with pytest.raises(ValueError):
        tka.masked_accumulate_leaves([], [], [])
    with pytest.raises(ValueError):
        tka.masked_accumulate_leaves([a, a], [a], [a[:, 0]])
    with pytest.raises(ValueError):
        tku.fused_uplink_leaves([], [], [])


# ----------------------------------------------------------------------
# UnitMap.accumulate: one grouped call, or a per-leaf callable
# ----------------------------------------------------------------------
def _reduced_trees(rng):
    shapes = jax.eval_shape(lambda: jcnn.init_params(
        jax.random.PRNGKey(0), jcnn.VGGConfig().reduced()))
    return [jax.tree.map(lambda s: rng.normal(size=s.shape)
                         .astype(np.float32), shapes) for _ in range(2)]


@pytest.mark.parametrize("macc", ["grouped", "per-leaf"])
def test_unitmap_accumulate_matches_reference_on_reduced_vgg9(macc):
    """The default makes one grouped call for every leaf; a per-leaf
    ``masked_accumulate=`` is called once a leaf, as in the reference."""
    rng = np.random.default_rng(13)
    acc_np, x_np = _reduced_trees(rng)
    ju = jun.UnitMap.build(acc_np)
    w = rng.normal(size=(ju.num_units,)).astype(np.float32)
    w[::3] = 0.0
    jacc, jx = (jax.tree.map(jnp.asarray, acc_np),
                jax.tree.map(jnp.asarray, x_np))
    tacc, tx = params_from_numpy(acc_np, "cpu"), params_from_numpy(x_np,
                                                                   "cpu")
    tu = tun.UnitMap.build(tacc)
    calls = []

    def per_leaf(a, x, w_rows):
        calls.append(a.shape)
        return ref.masked_accumulate(a, x, w_rows)

    want = ju.accumulate(jacc, jx, jnp.asarray(w))
    got = tu.accumulate(tacc, tx, torch.from_numpy(w),
                        masked_accumulate=per_leaf if macc == "per-leaf"
                        else None)
    assert got is tacc                          # in place, as documented
    for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-6)
    assert len(calls) == (len(jax.tree.leaves(acc_np))
                          if macc == "per-leaf" else 0)
    assert ops.launch_counts()["masked_accumulate"] == 0


def test_unitmap_accumulate_reference_kernel_callable():
    """The per-leaf argument takes the reference's own signature: the JAX
    Pallas kernel (interpret mode) through numpy gives the same sums."""
    rng = np.random.default_rng(14)
    acc_np, x_np = _reduced_trees(rng)
    tacc = params_from_numpy(acc_np, "cpu")
    tu = tun.UnitMap.build(tacc)
    w = torch.from_numpy(rng.normal(size=(tu.num_units,)).astype(np.float32))

    def pallas(a, x, w_rows):
        out = jka.masked_accumulate(jnp.asarray(a.numpy()),
                                    jnp.asarray(x.numpy()),
                                    jnp.asarray(w_rows.numpy()),
                                    interpret=True)
        return torch.from_numpy(np.array(out))

    want = tu.accumulate(params_from_numpy(acc_np, "cpu"),
                         params_from_numpy(x_np, "cpu"), w)
    got = tu.accumulate(tacc, params_from_numpy(x_np, "cpu"), w,
                        masked_accumulate=pallas)
    for x, y in zip(tun.tree_leaves(got), tun.tree_leaves(want)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


# ----------------------------------------------------------------------
# the packed uplink: one grouped call a round without error feedback
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ef", [False, True])
def test_packed_round_calls_the_grouped_uplink_once(ef):
    rng = np.random.default_rng(15)
    k = 5
    g_np, _ = _reduced_trees(rng)
    gp = params_from_numpy(g_np, "cpu")
    umap = tun.UnitMap.build(gp)
    locals_ = params_from_numpy(jax.tree.map(
        lambda l: (l + 0.02 * rng.normal(size=(k,) + l.shape))
        .astype(np.float32), g_np), "cpu")
    res = (params_from_numpy(jax.tree.map(
        lambda l: (1e-3 * rng.normal(size=(k,) + l.shape))
        .astype(np.float32), g_np), "cpu") if ef else None)
    strat = make_strategy(FLConfig(
        algo="fedldf", num_clients=10, clients_per_round=k, top_n=2,
        compression=CompressionConfig(bits=4, error_feedback=ef)))
    divs = umap.divergence(locals_, gp)
    sel = torch.zeros_like(divs)
    sel[:2] = 1.0
    sizes = torch.tensor([100.0, 150.0, 80.0, 120.0, 100.0])
    grouped, per_leaf = [], []

    def rec_leaves(*a):
        grouped.append(len(a[0]))
        return ref.fused_uplink_leaves(*a)

    def rec_ef(*a):
        per_leaf.append(a[0].shape)
        return ref.fused_uplink_ef(*a)

    new, _, _ = strat.uplink_round(locals_, gp, umap, sel, divs, sizes, res,
                                   fused_uplink_leaves=rec_leaves,
                                   fused_uplink_ef=rec_ef)
    n_leaves = len(tun.tree_leaves(gp))
    assert grouped == ([] if ef else [n_leaves])
    assert len(per_leaf) == (n_leaves if ef else 0)
    want, _, _ = strat.uplink_round(locals_, gp, umap, sel, divs, sizes, res)
    for a, b in zip(tun.tree_leaves(new), tun.tree_leaves(want)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the build: a library's name hashes the headers its source includes
# ----------------------------------------------------------------------
def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    first = _build.library_path("k")
    assert _build._sources(tmp_path / "k.cu") == [
        tmp_path / "k.cu", tmp_path / "a.cuh", tmp_path / "b.cuh"]
    (tmp_path / "b.cuh").write_text("// b, edited\n")   # nested header
    second = _build.library_path("k")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n//\n')
    third = _build.library_path("k")
    assert len({first, second, third}) == 3
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith("libk-")
               for p in (first, second, third))
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    assert _build.library_path("k") == first           # content, not time


def test_table_sources_include_the_leaf_table_header():
    for name in ("aggregate", "uplink"):
        assert _build._sources(_build.CSRC / f"{name}.cu")[1:] == [
            _build.CSRC / "leaf_table.cuh"]
    assert _build._sources(_build.CSRC / "divergence.cu") == [
        _build.CSRC / "divergence.cu"]
