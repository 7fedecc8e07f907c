"""On the card: the port's CUDA kernels against their plain PyTorch versions,
a round on the card against the same round on the CPU, and the serving path
through the flash-attention kernels (all three routes: tensor-core prefill,
split-KV decode, CUDA cores).

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.units import UnitMap, tree_leaves, tree_map  # noqa: E402
from repro_torch.data import (FederatedData, iid_partition,  # noqa: E402
                              make_image_dataset)
from repro_torch.federated import (CompressionConfig, FLConfig,  # noqa: E402
                                   build_round_fn, make_strategy,
                                   run_training)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import aggregate as tka  # noqa: E402
from repro_torch.kernels import divergence as tkd  # noqa: E402
from repro_torch.kernels import flash_attention as tkf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import uplink as tku  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

pytestmark = pytest.mark.gpu

SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]                  # tests/test_kernels.py:18
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"rtol": 3e-3, "atol": 1e-5}              # tests/test_kernels.py:33,45
EQUIV_TOL = 2e-5                  # benchmarks/round_engine_bench.py:59
# tests/test_wire.py:174-175 and :191, plus VGG-9 conv7.w at K = 20
UPLINK_SHAPES = [(1, 1, 1), (3, 7, 129), (4, 16, 2048), (5, 33, 2049),
                 (20, 1, 2359296)]
UPLINK_EF_SHAPES = [(2, 5, 64), (4, 16, 2048), (3, 9, 515),
                    (20, 1, 2359296)]
CFG = cnn.VGGConfig().reduced()


@pytest.fixture
def cuda():
    """A CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m gpu "
                    "tests/test_torch_gpu.py on one)")
    ops.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES + [(20, 2359296)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_sqdiff_rowsum_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = torch.randn(shape, generator=g, device=cuda, dtype=DTYPES[dtype])
    for rows_b in sorted({shape[0], 1}):
        b = torch.randn((rows_b, shape[1]), generator=g, device=cuda,
                        dtype=DTYPES[dtype])
        torch.testing.assert_close(ops.sqdiff_rowsum(a, b),
                                   ref.sqdiff_rowsum(a, b), **TOL)
    assert ops.launch_counts()["sqdiff_rowsum"] == len({shape[0], 1})


@pytest.mark.parametrize("shape", SHAPES + [(1, 2359296)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_masked_accumulate_matches_plain_bitwise(cuda, shape, dtype):
    """The kernel rounds product and sum separately, as the plain version
    does, so the two agree bit for bit, in place or not."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    acc = torch.randn(shape, generator=g, device=cuda)
    x = torch.randn(shape, generator=g, device=cuda, dtype=DTYPES[dtype])
    w = torch.randn(shape[:1], generator=g, device=cuda)
    want = ref.masked_accumulate(acc, x, w)
    torch.testing.assert_close(ops.masked_accumulate(acc, x, w), want,
                               rtol=0, atol=0)
    ops.masked_accumulate(acc, x, w, out=acc)
    torch.testing.assert_close(acc, want, rtol=0, atol=0)
    assert ops.launch_counts()["masked_accumulate"] == 2


def test_cuda_unaligned_views_take_the_scalar_path(cuda):
    base = torch.randn(3 * 1000 + 1, device=cuda)
    a = base[1:].view(3, 1000)                  # 4-byte, not 16-byte aligned
    b = torch.randn(3, 1000, device=cuda)
    torch.testing.assert_close(ops.sqdiff_rowsum(a, b),
                               ref.sqdiff_rowsum(a, b), **TOL)
    acc = torch.randn(3 * 1000 + 1, device=cuda)[1:].view(3, 1000)
    w = torch.randn(3, device=cuda)
    torch.testing.assert_close(ops.masked_accumulate(acc, a, w),
                               ref.masked_accumulate(acc, a, w),
                               rtol=0, atol=0)


def test_cuda_kernels_reject_bad_inputs(cuda):
    a = torch.ones(4, 10, device=cuda)
    with pytest.raises(ValueError):
        tkd.sqdiff_rowsum(a, torch.ones(3, 10, device=cuda))    # 4 % 3
    with pytest.raises(TypeError):
        tkd.sqdiff_rowsum(a.half(), a.half())
    with pytest.raises(ValueError):
        tka.masked_accumulate(a, a.t().contiguous().t(),
                              torch.ones(4, device=cuda))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def _uplink_inputs(shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    k, r, _ = shape
    levels = torch.randint(-127, 128, shape, generator=g, device=device,
                           dtype=torch.int8)
    scales = torch.rand((k, r), generator=g, device=device) + 1e-4
    w = torch.rand((k, r), generator=g, device=device)
    return g, levels, scales, w


@pytest.mark.parametrize("shape", UPLINK_SHAPES)
def test_cuda_fused_uplink_matches_plain_bitwise(cuda, shape):
    """Each product and sum is rounded on its own, in ascending k, as the
    plain version does: the two agree bit for bit."""
    _, levels, scales, w = _uplink_inputs(shape, cuda, sum(shape))
    torch.testing.assert_close(ops.fused_uplink(levels, scales, w),
                               ref.fused_uplink(levels, scales, w),
                               rtol=0, atol=0)
    assert ops.launch_counts()["fused_uplink"] == 1


@pytest.mark.parametrize("shape", UPLINK_EF_SHAPES)
@pytest.mark.parametrize("v_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e_dtype", ["f32", "bf16"])
def test_cuda_fused_uplink_ef_matches_plain_bitwise(cuda, shape, v_dtype,
                                                    e_dtype):
    g, levels, scales, w = _uplink_inputs(shape, cuda, shape[2])
    gate = (torch.rand(shape[:2], generator=g, device=cuda) < 0.5).float()
    v = torch.randn(shape, generator=g, device=cuda, dtype=DTYPES[v_dtype])
    e = torch.randn(shape, generator=g, device=cuda, dtype=DTYPES[e_dtype])
    num, res = ops.fused_uplink_ef(levels, scales, w, gate, v, e)
    want_num, want_res = ref.fused_uplink_ef(levels, scales, w, gate, v, e)
    torch.testing.assert_close(num, want_num, rtol=0, atol=0)
    torch.testing.assert_close(res, want_res, rtol=0, atol=0)
    off = gate == 0
    assert torch.equal(res[off], e.float()[off])
    assert ops.launch_counts()["fused_uplink_ef"] == 1


def test_cuda_uplink_unaligned_views_take_the_scalar_path(cuda):
    shape = (3, 2, 1000)
    _, levels, scales, w = _uplink_inputs(shape, cuda, 7)
    lv = torch.randint(-127, 128, (6001,), device=cuda,
                       dtype=torch.int8)[1:].view(shape)   # 1-byte offset
    v = torch.randn(6001, device=cuda)[1:].view(shape)     # 4-byte offset
    gate = torch.ones(shape[:2], device=cuda)
    torch.testing.assert_close(ops.fused_uplink(lv, scales, w),
                               ref.fused_uplink(lv, scales, w),
                               rtol=0, atol=0)
    for got, want in zip(ops.fused_uplink_ef(lv, scales, w, gate, v, v),
                         ref.fused_uplink_ef(lv, scales, w, gate, v, v)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_uplink_kernels_reject_bad_inputs(cuda):
    _, levels, scales, w = _uplink_inputs((2, 3, 8), cuda, 1)
    with pytest.raises(TypeError):
        tku.fused_uplink(levels.float(), scales, w)
    with pytest.raises(ValueError):
        tku.fused_uplink(levels, scales[:, :2].contiguous(), w)
    v = torch.zeros(2, 3, 8, device=cuda)
    with pytest.raises(TypeError):
        tku.fused_uplink_ef(levels, scales, w, w, v.half(), v)
    with pytest.raises(ValueError):
        tku.fused_uplink_ef(levels, scales, w, w, v.transpose(1, 2)
                            .contiguous().transpose(1, 2), v)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# The leaf-table kernels: one launch over a list of leaves. VGG-9's 34
# full-width leaves as the round sees them (one row a leaf), and the
# reference SHAPES that exercise the ragged, scalar and multi-row paths.
TABLE_SHAPES = [(1, 1), (9, 2049), (62, 33)]


def _vgg9_shapes():
    params = cnn.init_params(cnn.VGGConfig(), torch.Generator().manual_seed(0),
                             "cpu")
    return [(1, leaf.numel()) for leaf in tree_leaves(params)]


def _macc_table(device, shapes, dtype, seed):
    """(acc, x, w) a leaf; every third leaf's weights are 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    accs, xs, ws = [], [], []
    for i, shape in enumerate(shapes):
        accs.append(torch.randn(shape, generator=g, device=device))
        xs.append(torch.randn(shape, generator=g, device=device,
                              dtype=DTYPES[dtype]))
        w = torch.randn(shape[:1], generator=g, device=device)
        ws.append(w * 0 if i % 3 == 0 else w)
    return accs, xs, ws


def _check_macc_table(accs, xs, ws, launches):
    want = [ref.masked_accumulate(a, x, w) for a, x, w in zip(accs, xs, ws)]
    got = ops.masked_accumulate_leaves(accs, xs, ws)
    assert all(g is a for g, a in zip(got, accs))           # in place
    assert all(torch.equal(a, b) for a, b in zip(accs, want))
    assert ops.launch_counts()["masked_accumulate"] == launches


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_masked_accumulate_leaves_vgg9_table(cuda, dtype):
    """Every leaf of full-width VGG-9 in one launch, in place, bit for bit;
    fc.b (10 columns) takes the scalar path inside the same launch."""
    _check_macc_table(*_macc_table(cuda, _vgg9_shapes(), dtype, 1), 1)


@pytest.mark.parametrize("table", ["one-entry", "mixed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_masked_accumulate_leaves_reference_shapes(cuda, table, dtype):
    if table == "one-entry":
        for i, shape in enumerate(TABLE_SHAPES):
            _check_macc_table(*_macc_table(cuda, [shape], dtype, i), i + 1)
    else:
        shapes = TABLE_SHAPES + [(1, 4096), (4, 1000), (1, 10)]
        accs, xs, ws = _macc_table(cuda, shapes, dtype, 7)
        # a misaligned view among aligned leaves
        accs[3] = torch.randn(4097, device=cuda)[1:].view(1, 4096)
        _check_macc_table(accs, xs, ws, 1)


def test_cuda_masked_accumulate_leaves_chunks_a_long_table(cuda):
    """A table longer than one launch holds goes in chunks of 48 leaves."""
    shapes = [(1 + i % 3, 16 * (1 + i % 5)) for i in range(100)]
    _check_macc_table(*_macc_table(cuda, shapes, "f32", 3), 3)


def _uplink_table(device, shapes, k, seed, dense=False):
    """(levels, scales, w) a leaf of K clients; unless ``dense``, 4 of
    every 5 clients have w = 0, as fedldf's n = 4 of K = 20."""
    g = torch.Generator(device=device).manual_seed(seed)
    levels, scales, ws = [], [], []
    for r, c in shapes:
        levels.append(torch.randint(-127, 128, (k, r, c), generator=g,
                                    device=device, dtype=torch.int8))
        scales.append(torch.rand((k, r), generator=g, device=device) + 1e-4)
        w = torch.rand((k, r), generator=g, device=device)
        if not dense:
            w[torch.arange(k, device=device) % 5 != 0] = 0.0
        ws.append(w)
    return levels, scales, ws


def _check_uplink_table(levels, scales, ws, launches):
    want = [ref.fused_uplink(*a) for a in zip(levels, scales, ws)]
    got = ops.fused_uplink_leaves(levels, scales, ws)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan)
        assert torch.equal(a[~nan], b[~nan])
    assert ops.launch_counts()["fused_uplink"] == launches


@pytest.mark.parametrize("dense", [False, True], ids=["sparse-w", "dense-w"])
def test_cuda_fused_uplink_leaves_vgg9_table(cuda, dense):
    """One setting-B round's 34 leaves at K = 20 in one launch, bit for
    bit, with fedldf's w = 0 rows and with every w non-zero."""
    _check_uplink_table(*_uplink_table(cuda, _vgg9_shapes(), 20, 2, dense),
                        1)


@pytest.mark.parametrize("table", ["one-entry", "mixed"])
def test_cuda_fused_uplink_leaves_reference_shapes(cuda, table):
    if table == "one-entry":
        for i, shape in enumerate(TABLE_SHAPES):
            _check_uplink_table(*_uplink_table(cuda, [shape], 5, i), i + 1)
    else:
        shapes = TABLE_SHAPES + [(1, 4096), (3, 1000), (1, 10)]
        levels, scales, ws = _uplink_table(cuda, shapes, 5, 9)
        # a view at a 1-byte offset among aligned leaves
        levels[3] = torch.randint(-127, 128, (5 * 4096 + 1,), device=cuda,
                                  dtype=torch.int8)[1:].view(5, 1, 4096)
        _check_uplink_table(levels, scales, ws, 1)


def test_cuda_fused_uplink_leaves_skip_keeps_nan(cuda):
    """A w = 0 row is skipped only where its term is exactly ±0: with an
    inf, NaN or huge finite scale it is not, and gives the plain NaN."""
    levels, scales, ws = _uplink_table(cuda, [(1, 4096), (2, 10)] * 3, 5, 4)
    for i, bad in enumerate((float("inf"), float("nan"), 3e38)):
        ws[2 * i][1, 0] = 0.0
        scales[2 * i][1, 0] = bad
        ws[2 * i + 1][1, 1] = 0.0
        scales[2 * i + 1][1, 1] = bad
    _check_uplink_table(levels, scales, ws, 1)
    # inf and NaN scales: every column of those leaves is NaN
    assert all(bool(torch.isnan(n).all())
               for n in ops.fused_uplink_leaves(levels, scales, ws)[0:4:2])


def test_cuda_fused_uplink_leaves_chunks_a_long_table(cuda):
    shapes = [(1 + i % 2, 16 * (1 + i % 7)) for i in range(100)]
    _check_uplink_table(*_uplink_table(cuda, shapes, 3, 5), 3)


def test_cuda_leaf_tables_reject_bad_inputs(cuda):
    a = torch.ones(4, 16, device=cuda)
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        tka.masked_accumulate_leaves([a, a], [a], [w, w])
    with pytest.raises(ValueError):
        tka.masked_accumulate_leaves([a, a], [a, a.cpu()], [w, w])
    with pytest.raises(TypeError):
        tka.masked_accumulate_leaves([a, a], [a, a.half()], [w, w])
    levels, scales, ws = _uplink_table(cuda, [(1, 64), (1, 64)], 3, 0)
    with pytest.raises(ValueError):                  # two K in one table
        tku.fused_uplink_leaves([levels[0], levels[1][:2].contiguous()],
                                [scales[0], scales[1][:2].contiguous()],
                                [ws[0], ws[1][:2].contiguous()])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# The grouped Eq. 3 divergence and the grouped error-feedback uplink: one
# C call over a table of leaves.
def _sq_table(device, shapes, kk, dtype, seed):
    """(a (K·n, C), b (n, C), unit) a leaf of K clients; leaf i's rows are
    its own units."""
    g = torch.Generator(device=device).manual_seed(seed)
    a, b, units, off = [], [], [], 0
    for n, c in shapes:
        a.append(torch.randn((kk * n, c), generator=g, device=device,
                             dtype=DTYPES[dtype]))
        b.append(torch.randn((n, c), generator=g, device=device,
                             dtype=DTYPES[dtype]))
        units.append((off, n))
        off += n
    return a, b, units


def _check_sq_table(a, b, units, calls):
    """Within TOL of plain, and bit for bit the per-leaf kernel composed
    in leaf order from 0 (the same within-leaf order); ``calls`` C calls
    (one a chunk of 48 leaves)."""
    before = ops.launch_counts()["sqdiff_rowsum"]
    got = ops.sqdiff_rowsum_leaves(a, b, units)
    assert ops.launch_counts()["sqdiff_rowsum"] - before == calls
    torch.testing.assert_close(got, ref.sqdiff_rowsum_leaves(a, b, units),
                               **TOL)
    kk = got.shape[0]
    composed = torch.zeros_like(got)
    for x, y, (off, n) in zip(a, b, units):
        composed[:, off:off + n] = (composed[:, off:off + n]
                                    + tkd.sqdiff_rowsum(x, y).reshape(kk, n))
    assert torch.equal(got, composed)
    assert torch.equal(got, ops.sqdiff_rowsum_leaves(a, b, units))  # again
    return got


@pytest.mark.parametrize("kk", [20, 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_sqdiff_rowsum_leaves_vgg9_table(cuda, kk, dtype):
    """A vmap round's (K = 20) and a scan-round client's (K = 1) Eq. 3 over
    VGG-9's 34 full-width leaves in one call; fc.b takes the scalar path."""
    _check_sq_table(*_sq_table(cuda, _vgg9_shapes(), kk, dtype, kk), 1)


@pytest.mark.parametrize("table", ["one-entry", "mixed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_sqdiff_rowsum_leaves_reference_shapes(cuda, table, dtype):
    if table == "one-entry":
        for i, shape in enumerate(TABLE_SHAPES):
            _check_sq_table(*_sq_table(cuda, [shape], 3, dtype, i), 1)
    else:
        a, b, units = _sq_table(cuda, TABLE_SHAPES + [(1, 4096), (4, 1000),
                                                     (1, 10)], 3, dtype, 7)
        # a misaligned view among aligned leaves, on unit 0 with leaf 0
        # (unit 72 then has no leaf and stays 0)
        a[3] = torch.randn(3 * 4096 + 1, device=cuda,
                           dtype=DTYPES[dtype])[1:].view(3, 4096)
        units[3] = (0, 1)
        got = _check_sq_table(a, b, units, 1)
        assert bool((got[:, 72] == 0).all())


def test_cuda_sqdiff_rowsum_leaves_stacked_units(cuda):
    """A stacked subtree: leaves of n = 3 rows (units 2 .. 4) beside plain
    units, K = 4."""
    shapes = [(1, 10), (1, 4096), (3, 20), (3, 4096), (1, 33)]
    a, b, _ = _sq_table(cuda, shapes, 4, "f32", 11)
    units = [(0, 1), (1, 1), (2, 3), (2, 3), (5, 1)]
    got = _check_sq_table(a, b, units, 1)
    assert got.shape == (4, 6)


def test_cuda_sqdiff_rowsum_leaves_chunks_a_long_table(cuda):
    """100 leaves go in chunks of 48: 3 calls, later chunks adding to the
    earlier ones' unit sums in leaf order."""
    shapes = [(1 + i % 3, 16 * (1 + i % 5)) for i in range(100)]
    a, b, units = _sq_table(cuda, shapes, 2, "f32", 3)
    units = [(i % 7, n) for i, (n, _) in enumerate(shapes)]  # shared units
    got = ops.sqdiff_rowsum_leaves(a, b, units)
    assert ops.launch_counts()["sqdiff_rowsum"] == 3
    torch.testing.assert_close(got, ref.sqdiff_rowsum_leaves(a, b, units),
                               **TOL)


def _ef_table(device, shapes, kk, v_dtype, e_dtype, seed):
    """(levels, v, e_old) a leaf of K clients and the shared (K, U) scales,
    w and gate; 4 of every 5 clients have gate = 0 and w = 0, as fedldf's
    n = 4 of K = 20."""
    g = torch.Generator(device=device).manual_seed(seed)
    levels, v, e, units, off = [], [], [], [], 0
    for n, c in shapes:
        levels.append(torch.randint(-127, 128, (kk, n, c), generator=g,
                                    device=device, dtype=torch.int8))
        v.append(torch.randn((kk, n, c), generator=g, device=device,
                             dtype=DTYPES[v_dtype]))
        e.append(torch.randn((kk, n, c), generator=g, device=device,
                             dtype=DTYPES[e_dtype]))
        units.append((off, n))
        off += n
    scales = torch.rand((kk, off), generator=g, device=device) + 1e-4
    gate = (torch.arange(kk, device=device) % 5 == 0).float()[:, None] \
        .expand(kk, off).contiguous()
    w = torch.rand((kk, off), generator=g, device=device) * gate
    return levels, v, e, units, scales, w, gate


def _check_ef_table(levels, v, e, units, scales, w, gate, calls,
                    keeps_e=True):
    """Bit for bit, NaN where the plain version has NaN, in ``calls``
    launches; gate = 0 rows keep e_old (with finite inputs)."""
    want = ref.fused_uplink_ef_leaves(levels, v, e, units, scales, w, gate)
    before = ops.launch_counts()["fused_uplink_ef"]
    got = ops.fused_uplink_ef_leaves(levels, v, e, units, scales, w, gate)
    assert ops.launch_counts()["fused_uplink_ef"] - before == calls
    for (num, res), (wn, wr), ee, (off, n) in zip(got, want, e, units):
        for a, b_ in ((num, wn), (res, wr)):
            assert a.shape == b_.shape and a.dtype == torch.float32
            nan = torch.isnan(b_)
            assert torch.equal(torch.isnan(a), nan)
            assert torch.equal(a[~nan], b_[~nan])
        off_rows = gate[:, off:off + n] == 0
        assert not keeps_e or torch.equal(res[off_rows], ee.float()[off_rows])


@pytest.mark.parametrize("v_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e_dtype", ["f32", "bf16"])
def test_cuda_fused_uplink_ef_leaves_vgg9_table(cuda, v_dtype, e_dtype):
    """One setting-A round's 34 leaves at K = 20 in one launch, bit for
    bit; fc.b takes the scalar path."""
    _check_ef_table(*_ef_table(cuda, _vgg9_shapes(), 20, v_dtype, e_dtype,
                               2), 1)


@pytest.mark.parametrize("table", ["one-entry", "mixed"])
def test_cuda_fused_uplink_ef_leaves_reference_shapes(cuda, table):
    if table == "one-entry":
        for i, shape in enumerate(TABLE_SHAPES):
            _check_ef_table(*_ef_table(cuda, [shape], 5, "f32", "f32", i), 1)
    else:
        shapes = TABLE_SHAPES + [(1, 4096), (3, 1000), (1, 10)]
        levels, v, e, units, scales, w, gate = _ef_table(
            cuda, shapes, 5, "f32", "bf16", 9)
        # views at a 1-byte (levels) and 4-byte (v) offset among aligned
        # leaves
        levels[3] = torch.randint(-127, 128, (5 * 4096 + 1,), device=cuda,
                                  dtype=torch.int8)[1:].view(5, 1, 4096)
        v[3] = torch.randn(5 * 4096 + 1, device=cuda)[1:].view(5, 1, 4096)
        _check_ef_table(levels, v, e, units, scales, w, gate, 1)


def test_cuda_fused_uplink_ef_leaves_non_finite(cuda):
    """inf, NaN and 3e38 scales and a non-finite v, with gate and w both 0
    and both 1: the kernel reads every row, so it gives the plain NaN and
    inf exactly where the plain version does."""
    levels, v, e, units, scales, w, gate = _ef_table(
        cuda, [(1, 4096), (2, 10)] * 3, 5, "f32", "f32", 4)
    for i, bad in enumerate((float("inf"), float("nan"), 3e38)):
        off = units[2 * i][0]
        scales[1, off] = bad                 # gate = 0, w = 0
        scales[0, off + 1] = bad             # gate = 1
        v[2 * i + 1][1, 0, 3] = bad
    _check_ef_table(levels, v, e, units, scales, w, gate, 1, keeps_e=False)


def test_cuda_fused_uplink_ef_leaves_chunks_a_long_table(cuda):
    shapes = [(1 + i % 2, 16 * (1 + i % 7)) for i in range(100)]
    _check_ef_table(*_ef_table(cuda, shapes, 3, "f32", "f32", 5), 3)


def test_cuda_grouped_tables_reject_bad_inputs(cuda):
    a = torch.ones(4, 16, device=cuda)
    with pytest.raises(ValueError):                  # 4 rows, 3 units
        tkd.sqdiff_rowsum_leaves([a], [a[:3]], [(0, 3)])
    with pytest.raises(TypeError):
        tkd.sqdiff_rowsum_leaves([a, a.half()], [a[:1], a[:1].half()],
                                 [(0, 1), (1, 1)])
    with pytest.raises(ValueError):                  # two K in one table
        tkd.sqdiff_rowsum_leaves([a, a[:2].contiguous()], [a[:1], a[:1]],
                                 [(0, 1), (1, 1)])
    levels, v, e, units, scales, w, gate = _ef_table(
        cuda, [(1, 64), (2, 64)], 3, "f32", "f32", 0)
    with pytest.raises(ValueError):                  # units past U
        tku.fused_uplink_ef_leaves(levels, v, e, [(0, 1), (2, 2)], scales,
                                   w, gate)
    with pytest.raises(ValueError):                  # (K, U) mismatch
        tku.fused_uplink_ef_leaves(levels, v, e, units, scales[:2], w, gate)
    with pytest.raises(TypeError):
        tku.fused_uplink_ef_leaves(levels, [v[0].half(), v[1]], e, units,
                                   scales, w, gate)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("bits,ef", [(8, True), (4, False)])
def test_cuda_compressed_round_matches_cpu_round(cuda, bits, ef):
    """One compressed fedldf round through the uplink kernels on the card
    against the same round through the plain versions on the CPU: equal
    selection, params within 2e-5 plus one quantization step."""
    params = cnn.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"images": rng.normal(size=(5, 8, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(5, 8)).astype(np.int32)}
    sizes = np.array([100.0, 150.0, 80.0, 120.0, 100.0], np.float32)
    fl = FLConfig(num_clients=10, clients_per_round=5, top_n=2,
                  batch_per_client=8,
                  compression=CompressionConfig(bits=bits, error_feedback=ef))
    umap = UnitMap.build(params)
    round_fn = build_round_fn(lambda p, b: cnn.classify_loss(p, CFG, b),
                              umap, fl)
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = make_strategy(fl).init_state(p, 5)
        outs[str(dev)] = round_fn(p, b, torch.from_numpy(sizes).to(dev),
                                  state)
    (new_c, m_c), (new_g, m_g) = outs["cpu"], outs["cuda"]
    assert torch.equal(m_g["selection"].cpu(), m_c["selection"])
    step = m_c["wire"]["payload"].scales.amax(dim=0)
    for key, (off, _) in umap.spans.items():
        for a, c in zip(tree_leaves(new_g[key]), tree_leaves(new_c[key])):
            torch.testing.assert_close(a.cpu(), c, rtol=0,
                                       atol=EQUIV_TOL + float(step[off]))
    counts = ops.launch_counts()
    # one call over the leaf table, with or without error feedback, and one
    # grouped Eq. 3 call
    assert counts["fused_uplink_ef" if ef else "fused_uplink"] == 1
    assert counts["sqdiff_rowsum"] == 1


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_cuda_round_matches_cpu_round(cuda, mode):
    """One fedldf round through the kernels on the card equals the same
    round through the plain versions on the CPU."""
    params = cnn.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"images": rng.normal(size=(5, 8, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(5, 8)).astype(np.int32)}
    sizes = np.array([100.0, 150.0, 80.0, 120.0, 100.0], np.float32)
    fl = FLConfig(num_clients=10, clients_per_round=5, top_n=2, mode=mode,
                  batch_per_client=8)
    umap = UnitMap.build(params)
    round_fn = build_round_fn(lambda p, b: cnn.classify_loss(p, CFG, b),
                              umap, fl)
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        outs[str(dev)] = round_fn(p, b, torch.from_numpy(sizes).to(dev))
    (new_c, m_c), (new_g, m_g) = outs["cpu"], outs["cuda"]
    torch.testing.assert_close(m_g["divergence"].cpu(), m_c["divergence"],
                               **TOL)
    assert torch.equal(m_g["selection"].cpu(), m_c["selection"])
    for a, c in zip(tree_leaves(new_g), tree_leaves(new_c)):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=EQUIV_TOL)
    counts = ops.launch_counts()
    assert counts["sqdiff_rowsum"] > 0
    assert (counts["masked_accumulate"] > 0) == (mode == "scan")


def test_cuda_run_training_launches_kernels(cuda):
    train, _ = make_image_dataset(num_train=200, num_test=8, seed=0)
    data = FederatedData(train.xs, train.ys, iid_partition(train.ys, 10))
    params = cnn.init_params(CFG, torch.Generator().manual_seed(0), cuda)
    fl = FLConfig(num_clients=10, clients_per_round=5, top_n=2, mode="scan",
                  batch_per_client=8)
    out, log = run_training(params, lambda p, b: cnn.classify_loss(p, CFG, b),
                            data, fl, rounds=2, device=cuda)
    assert all(l.is_cuda and bool(torch.isfinite(l).all())
               for l in tree_leaves(out))
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    # scan mode: one launch over the leaf table a client and round
    assert ops.launch_counts()["masked_accumulate"] == 2 * 5


# tests/test_flash_kernel.py CASES: (bh, bkv, sq, skv, hd, causal, window)
FLASH_CASES = [(4, 2, 64, 64, 32, True, 0), (2, 2, 100, 100, 32, True, 0),
               (6, 2, 48, 48, 16, True, 7), (2, 1, 33, 65, 64, False, 0),
               (8, 1, 40, 40, 128, True, 0)]
FLASH_TOL = {"f32": 1e-4, "bf16": 2e-2}      # tests/test_flash_kernel.py:37


def _flash_inputs(device, q_shape, kv_shape, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device, dtype=DTYPES[dtype])
            for s in (q_shape, kv_shape, kv_shape)]


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(i) for i in range(len(FLASH_CASES))])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda, case, dtype):
    bh, bkv, sq, skv, hd, causal, window = case
    q, k, v = _flash_inputs(cuda, (bh, sq, hd), (bkv, skv, hd), dtype,
                            sum(case[:5]))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, ref.flash_attention(q, k, v, causal=causal, window=window),
           dtype)
    assert ops.launch_counts()["flash_attention"] == 1
    route = tkf.route(q.dtype, sq, hd)
    assert ops.launch_counts()[f"flash_attention_{route}"] == 1
    assert route == ("tc" if dtype == "bf16" and hd in (64, 128)
                     else "cuda_core")


def test_cuda_flash_attention_fully_masked_rows_are_zero(cuda):
    q, k, v = _flash_inputs(cuda, (2, 64, 16), (2, 16, 16), "f32", 0)
    got = ops.flash_attention(q, k, v, causal=False, window=8)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, 23:] == 0).all())     # rows that see no key
    _close(got, ref.flash_attention(q, k, v, causal=False, window=8), "f32")


@pytest.mark.parametrize("kv_len", [0, 1, 31, 64, 65, 100])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 9)])
def test_cuda_flash_attention_kv_len(cuda, kv_len, causal, window):
    q, k, v = _flash_inputs(cuda, (6, 100, 64), (3, 100, 64), "f32", kv_len)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    _close(got, ref.flash_attention(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len), "f32")


@pytest.mark.parametrize("shape", ["prefill", "decode"])
def test_cuda_flash_attention_full_width(cuda, shape):
    """qwen3-1.7b at batch 4: 16 heads over 8 KV heads, hd 128, bf16."""
    if shape == "prefill":
        q, k, v = _flash_inputs(cuda, (64, 2048, 128), (32, 2048, 128),
                                "bf16", 1)
        _close(ops.flash_attention(q, k, v, causal=True),
               ref.flash_attention(q, k, v, causal=True), "bf16")
        assert ops.launch_counts()["flash_attention_tc"] == 1
        return
    q, k, v = _flash_inputs(cuda, (64, 1, 128), (32, 2080, 128), "bf16", 2)
    for kv_len in (1, 2049, 2080):
        _close(ops.flash_attention(q, k, v, causal=False, kv_len=kv_len),
               ref.flash_attention(q, k, v, causal=False, kv_len=kv_len),
               "bf16")
    assert ops.launch_counts()["flash_attention_decode"] == 3


def test_cuda_flash_attention_takes_model_views(cuda):
    """(B, S, H, hd) views of a (B, S, H·hd) projection and a slice of a
    stacked cache go in without copies and match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qp = torch.randn(2, 40, 4 * 32, generator=g, device=cuda)
    cache = torch.randn(3, 2, 48, 2, 32, generator=g, device=cuda)
    q, k, v = qp.view(2, 40, 4, 32), cache[1][:, :40], cache[2][:, :40]
    assert not k.is_contiguous()
    _close(ops.flash_attention(q, k, v, causal=True, window=5),
           ref.flash_attention(q, k, v, causal=True, window=5), "f32")
    one = qp[:, :1].reshape(2, 1, 4, 32)
    _close(ops.flash_attention(one, cache[1], cache[2], causal=False,
                               kv_len=17),
           ref.flash_attention(one, cache[1], cache[2], causal=False,
                               kv_len=17), "f32")


def test_cuda_flash_attention_rejects_bad_inputs(cuda):
    q, k, v = _flash_inputs(cuda, (4, 8, 32), (2, 8, 32), "f32", 0)
    with pytest.raises(ValueError):                     # hd 48
        tkf.flash_attention(*_flash_inputs(cuda, (4, 8, 48), (2, 8, 48),
                                           "f32", 0))
    with pytest.raises(TypeError):                      # dtype mix
        tkf.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(RuntimeError, match="backward"):
        tkf.flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError):                     # a CPU tensor
        tkf.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):                     # kv_len > Skv
        tkf.flash_attention(q, k, v, kv_len=9)
    with pytest.raises(ValueError):                     # 8-byte offset
        base = torch.randn(2 * 8 * 32 + 2, device=cuda)[2:]
        tkf.flash_attention(q, base.view(2, 8, 32), v)
    q4 = q.view(1, 4, 8, 32).transpose(1, 2)
    k4 = k.view(1, 2, 8, 32).transpose(1, 2)
    with pytest.raises(NotImplementedError):
        tattn.attend(q4, k4, k4, kv_valid=torch.ones(1, 8, dtype=torch.bool,
                                                     device=cuda))
    with pytest.raises(NotImplementedError):
        tattn.attend(q4, k4, k4, q_pos=torch.arange(8, device=cuda))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cuda_decode_matches_forward_through_the_kernel(cuda):
    """A small dense model with a sliding window: prefill into a
    prompt-sized ring buffer, then decode past it (the buffer wraps);
    every step's logits equal forward's at that position, all through the
    kernel, and equal the CPU path's."""
    cfg = ModelConfig(name="t-dense", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, vocab_size=97, sliding_window=6)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 97, size=(2, 20)))
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        t = toks.to(dev)
        with torch.inference_mode():
            full, _ = ttf.forward(p, cfg, t)
            lg, cache = tdec.prefill(p, cfg, t[:, :10])
            steps = [lg]
            for i in range(10, 20):
                lg, cache = tdec.decode_step(p, cfg, t[:, i:i + 1], cache)
                torch.testing.assert_close(lg, full[:, i], rtol=1e-4,
                                           atol=1e-4)
                steps.append(lg)
        outs[str(dev)] = torch.stack(steps).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)
    # forward once, prefill once, 10 decode steps: 2 layers each; the f32
    # forward (20 rows) takes the CUDA cores, the 10-row prefill and the
    # decode steps (Sq <= 16) the split-KV kernel
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * 12
    assert counts["flash_attention_cuda_core"] == 2 * 1
    assert counts["flash_attention_decode"] == 2 * 11


def test_cuda_serving_launches_once_per_layer_at_full_depth(cuda):
    """qwen3-1.7b's 28 layers (at reduced width): 28 kernel launches per
    prefill and per decode step."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              num_layers=28)
    params = ttf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    pre = f"flash_attention_{tkf.route(torch.bfloat16, 24, cfg.hd)}"
    with torch.inference_mode():
        lg, cache = tdec.prefill(params, cfg, toks, max_len=28)
        assert ops.launch_counts()["flash_attention"] == 28
        assert ops.launch_counts()[pre] == 28
        for i in range(3):
            lg, cache = tdec.decode_step(params, cfg, lg.argmax(-1)[:, None],
                                         cache)
            assert ops.launch_counts()["flash_attention"] == 28 * (i + 2)
            assert ops.launch_counts()["flash_attention_decode"] == \
                28 * (i + 1)
    assert bool(torch.isfinite(lg).all()) and lg.shape == (2, cfg.vocab_size)


# -- the two new routes: split-KV decode and tensor-core prefill ----------
def _bshd(device, b, sq, h, kvh, skv, hd, dtype, seed):
    """(B, S, H, hd) q and (B, Skv, KV, hd) k, v."""
    return _flash_inputs(device, (b, sq, h, hd), (b, skv, kvh, hd), dtype,
                         seed)


@pytest.mark.parametrize("sq", [1, 5, 16])
@pytest.mark.parametrize("group", [1, 2, 7, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_decode_route_matches_plain(cuda, sq, group, dtype):
    """Sq <= 16 over grouped heads, kv_len at 0, 1, a split boundary ± 1
    and Skv, causal and windowed."""
    b, kvh, skv, hd = 2, 2, 600, 128
    q, k, v = _bshd(cuda, b, sq, kvh * group, kvh, skv, hd, dtype,
                    sq + group)
    rows = group * sq
    blocks = b * kvh * -(-rows // tkf.decode_row_block(rows))
    _, chunk = tkf.decode_plan(blocks, skv,
                               tkf.decode_tile(hd, q.element_size()))
    n = 0
    for kv_len in (0, 1, chunk - 1, chunk, chunk + 1, skv):
        for causal, window in ((False, 0), (True, 0), (False, 9)):
            kw = {"causal": causal, "window": window, "kv_len": kv_len}
            got = ops.flash_attention(q, k, v, **kw)
            assert bool(torch.isfinite(got).all())
            _close(got, ref.flash_attention(q, k, v, **kw), dtype)
            n += 1
    counts = ops.launch_counts()
    assert counts["flash_attention_decode"] == counts["flash_attention"] == n


def test_cuda_flash_decode_splits_merge_in_a_fixed_order(cuda):
    """Many splits (qwen3-1.7b's decode shape): the merge has no atomics,
    so two calls agree bit for bit."""
    q, k, v = _bshd(cuda, 4, 1, 16, 8, 2081, 128, "bf16", 4)
    splits, _ = tkf.decode_plan(32, 2049, tkf.decode_tile(128, 2))
    assert splits > 1
    first = ops.flash_attention(q, k, v, causal=False, kv_len=2049)
    again = ops.flash_attention(q, k, v, causal=False, kv_len=2049)
    assert torch.equal(first, again)
    _close(first, ref.flash_attention(q, k, v, causal=False, kv_len=2049),
           "bf16")


# (hd, sq, skv, kv_len, causal, window): ragged Sq (33, 40, 100, 129, 300),
# kv_len < Skv, windows, kv_len = 0 and one tile exactly
TC_CASES = [(64, 33, 65, 65, False, 0), (128, 40, 40, 40, True, 0),
            (64, 100, 100, 100, True, 0), (128, 40, 200, 150, True, 0),
            (64, 300, 300, 300, True, 17), (128, 300, 300, 0, True, 0),
            (128, 129, 300, 257, False, 100), (64, 128, 128, 128, True, 0),
            (128, 17, 17, 17, True, 5), (128, 256, 256, 200, False, 0)]


@pytest.mark.parametrize("case", TC_CASES,
                         ids=[str(i) for i in range(len(TC_CASES))])
def test_cuda_flash_tc_route_matches_plain(cuda, case):
    hd, sq, skv, kv_len, causal, window = case
    q, k, v = _bshd(cuda, 2, sq, 4, 2, skv, hd, "bf16", sum(case[:4]))
    kw = {"causal": causal, "window": window, "kv_len": kv_len}
    got = ops.flash_attention(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    _close(got, ref.flash_attention(q, k, v, **kw), "bf16")
    if kv_len == 0:
        assert bool((got == 0).all())
    assert ops.launch_counts()["flash_attention_tc"] == 1


@pytest.mark.parametrize("route", ["tc", "decode"])
def test_cuda_flash_new_routes_fully_masked_rows_are_zero(cuda, route):
    if route == "tc":           # q 64 x k 16 at window 8: rows 23.. see none
        q, k, v = _flash_inputs(cuda, (2, 64, 64), (2, 16, 64), "bf16", 0)
        kw, masked = {"causal": False, "window": 8}, slice(23, None)
    else:                       # 16 rows at window 3 over 4 keys: rows 6..
        q, k, v = _flash_inputs(cuda, (4, 16, 64), (2, 20, 64), "f32", 0)
        kw, masked = ({"causal": False, "window": 3, "kv_len": 4},
                      slice(6, None))
    got = ops.flash_attention(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, masked] == 0).all())
    _close(got, ref.flash_attention(q, k, v, **kw),
           "bf16" if route == "tc" else "f32")
    assert ops.launch_counts()[f"flash_attention_{route}"] == 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_new_routes_take_model_views(cuda, dtype):
    """(B, S, H, hd) views of a (B, S, H·hd) projection and slices of a
    stacked cache go in without copies: bf16 prefill on the tensor cores,
    a decode step on the split-KV kernel."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qp = torch.randn(2, 40, 4 * 64, generator=g, device=cuda,
                     dtype=DTYPES[dtype])
    cache = torch.randn(3, 2, 48, 2, 64, generator=g, device=cuda,
                        dtype=DTYPES[dtype])
    q, k, v = qp.view(2, 40, 4, 64), cache[1][:, :40], cache[2][:, :40]
    assert not k.is_contiguous()
    _close(ops.flash_attention(q, k, v, causal=True, window=5),
           ref.flash_attention(q, k, v, causal=True, window=5), dtype)
    one = qp[:, 7:8].view(2, 1, 4, 64)
    assert not one.is_contiguous()
    _close(ops.flash_attention(one, cache[1], cache[2], causal=False,
                               kv_len=33),
           ref.flash_attention(one, cache[1], cache[2], causal=False,
                               kv_len=33), dtype)
    counts = ops.launch_counts()
    assert counts["flash_attention_decode"] == 1
    assert counts["flash_attention_tc" if dtype == "bf16"
                  else "flash_attention_cuda_core"] == 1


def test_cuda_flash_each_call_counts_its_route(cuda):
    calls = [((2, 40, 4, 64), "bf16", "tc"), ((2, 40, 4, 32), "bf16",
                                               "cuda_core"),
             ((2, 40, 4, 64), "f32", "cuda_core"), ((2, 1, 4, 64), "bf16",
                                                     "decode"),
             ((2, 16, 4, 16), "f32", "decode")]
    for i, (shape, dtype, route) in enumerate(calls):
        b, sq, h, hd = shape
        assert tkf.route(DTYPES[dtype], sq, hd) == route
        before = ops.launch_counts()
        ops.flash_attention(*_bshd(cuda, b, sq, h, 2, 40, hd, dtype, i))
        after = ops.launch_counts()
        moved = {n for n in ops.KERNELS if after[n] != before[n]}
        assert moved == {"flash_attention", f"flash_attention_{route}"}


def test_cuda_flash_new_routes_reject_bad_inputs(cuda):
    q, k, v = _bshd(cuda, 1, 40, 4, 2, 40, 64, "bf16", 0)
    with pytest.raises(ValueError):                     # 8-byte offset
        base = torch.randn(40 * 2 * 64 + 4, device=cuda,
                           dtype=torch.bfloat16)[4:]
        tkf.flash_attention(q, base.view(1, 40, 2, 64), v)
    with pytest.raises(RuntimeError, match="backward"):
        tkf.flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError):                     # kv_len > Skv
        tkf.flash_attention(q[:, :1], k, v, kv_len=41)
    with pytest.raises(ValueError):                     # hd 48
        tkf.flash_attention(*_bshd(cuda, 1, 1, 4, 2, 8, 48, "bf16", 0))
    with pytest.raises(TypeError):                      # dtype mix
        tkf.flash_attention(q[:, :1], k.float(), v)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
