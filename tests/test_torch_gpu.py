"""On the card: the port's CUDA kernels against their plain PyTorch versions,
a round on the card against the same round on the CPU, the multi-round
engine (against the CPU engine, no host sync in a block, resume bit for
bit), the serving path through the flash-attention kernels (all three
routes: tensor-core prefill, split-KV decode, CUDA cores), and LoRA
fine-tuning through the kernel's differentiable form (``FlashAttentionFn``
under ``torch.func``, a partitioned round against the CPU, remat blocks),
the ssm and hybrid kinds (the SSD's chunked form against its
recurrence, hymba-1.5b's attention shapes on every route, a small hybrid
and ssm model's serving against the CPU, and an 8-layer hybrid's gradient
and backward peak against the former slice a layer of the stacked
blocks), and the moe kind (``moe_fwd``
against a per-expert loop with choices dropped and no host sync,
deepseek-moe-16b's attention shapes, a small moe model's serving and its
``vmap(grad)`` of ``lm_loss`` against the CPU), granite-4.0-h (its
held experts' share at full width against the per-expert loop without a
host sync, and a scan block of the patterned stack without one), and the
enc-dec kinds
(seamless-m4t-large-v2's attention shapes, a small enc-dec model's
serving and its ``vmap(grad)`` of ``lm_loss`` against the CPU), and round
telemetry (a telemetry-on round and the engine's ledger against the CPU,
a telemetry-on block without a host sync, ``device_memory_peak``), and
the client mesh (a world of 2 gloo ranks on the card: its collectives
staged through pinned host memory, and the engine on the mesh against
the engine on one device), and the 2-D mesh (a 1 × 2 grid of 2 gloo
ranks: the bytes at rest a rank, and the engine against the 1-rank
mesh).

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
from repro_torch.core.comm import comm_acc_init  # noqa: E402
from repro_torch.data import ClientShards  # noqa: E402
from repro_torch.federated import (CompressionConfig, FLConfig,  # noqa: E402
                                   KeyedDraws, build_round_fn, make_strategy,
                                   run_training, run_training_scan)
from repro_torch.federated import server as fl_server  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import aggregate as tka  # noqa: E402
from repro_torch.kernels import divergence as tkd  # noqa: E402
from repro_torch.kernels import flash_attention as tkf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import uplink as tku  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.telemetry import (TelemetryConfig, read_ledger,  # noqa: E402
                                   split_runs)
from repro_torch.telemetry.profiling import device_memory_peak  # noqa: E402
from torch_moe_loop import moe_loop  # noqa: E402

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


# ----------------------------------------------------------------------
# the device-resident engine on the card
# ----------------------------------------------------------------------
ENGINE_CASES = {
    "fedldf_vmap": dict(),
    "fedldf_scan": dict(mode="scan"),
    "int8_ef": dict(compression=CompressionConfig(bits=8,
                                                  error_feedback=True)),
    "fedlama": dict(algo="fedlama"),
    "random": dict(algo="random"),
    "fedadp_scan": dict(algo="fedadp", mode="scan"),
}


def _engine_task():
    train, _ = make_image_dataset(num_train=200, num_test=8, seed=0)
    data = FederatedData(train.xs, train.ys, iid_partition(train.ys, 10))
    params = cnn.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return params, data


def _engine_fl(case):
    return FLConfig(num_clients=10, clients_per_round=5, top_n=2,
                    batch_per_client=8, **ENGINE_CASES[case])


def _loss(p, b):
    return cnn.classify_loss(p, CFG, b)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cuda_engine_matches_cpu_engine(cuda, case):
    """run_training_scan on the card against the same call on the CPU: the
    keyed streams draw on the CPU, so both see the same clients, batches
    and uniforms; params within 2e-5 (plus one int8 step with EF), losses
    within 1e-5, the same uplink."""
    params, data = _engine_task()
    fl = _engine_fl(case)
    pc, lc = run_training_scan(params, _loss, data, fl, rounds=2, seed=3,
                               device="cpu")
    pg, lg = run_training_scan(params, _loss, data, fl, rounds=2, seed=3,
                               device=cuda)
    np.testing.assert_allclose(lg.losses, lc.losses, atol=1e-5, rtol=0)
    assert lg.meter.uplink_bytes == pytest.approx(lc.meter.uplink_bytes)
    atol = EQUIV_TOL
    if fl.compression is not None:
        atol += max(float(l.abs().max()) for l in tree_leaves(pc)) / 127.0
    for a, c in zip(tree_leaves(pg), tree_leaves(pc)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=atol)
    counts = ops.launch_counts()
    strat = make_strategy(fl)
    if strat.needs_divergence:
        assert counts["sqdiff_rowsum"] == (2 if fl.mode == "vmap" else 10)
    assert counts["masked_accumulate"] == \
        (10 if fl.mode == "scan" and strat.eq5_weighted else 0)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cuda_engine_block_does_not_sync(cuda, case):
    """A 2-round block enqueues without one host sync
    (``torch.cuda.set_sync_debug_mode("error")`` raises on any), and its
    outputs come back in one pull."""
    params, data = _engine_task()
    fl = _engine_fl(case)
    p = tree_map(lambda l: l.to(cuda), params)
    shards = ClientShards.from_federated(data).to(cuda)
    host_sizes, all_sizes = shards.part_sizes.cpu(), shards.data_sizes()
    run_block = fl_server._build_block_fn(_loss, UnitMap.build(p), fl)

    def carry():
        return (p, make_strategy(fl).init_state(p, fl.num_clients),
                comm_acc_init(cuda))

    draws = KeyedDraws(0)
    run_block(carry(), shards, all_sizes, host_sizes, draws, 0, 2)  # warm
    c0 = carry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (p2, state, acc), per = run_block(c0, shards, all_sizes, host_sizes,
                                          draws, 0, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pulled = torch.stack([per["loss"], per["uplink_bytes"]]).cpu()
    assert pulled.shape == (2, 2) and bool(torch.isfinite(pulled).all())
    assert float(acc["rounds"]) == 2.0


@pytest.mark.parametrize("case", ["fedldf_vmap", "int8_ef", "fedlama"])
@pytest.mark.parametrize("driver", ["engine", "device_sampler"])
def test_cuda_resume_is_bit_identical(cuda, case, driver):
    params, data = _engine_task()
    fl = _engine_fl(case)

    def run(p, rounds, **kw):
        if driver == "engine":
            return run_training_scan(p, _loss, data, fl, rounds=rounds,
                                     seed=1, device=cuda, **kw)
        return run_training(p, _loss, data, fl, rounds=rounds, seed=1,
                            sampler="device", device=cuda, **kw)

    p4, l4 = run(params, 4)
    p2, l2 = run(params, 2)
    p_res, l_res = run(p2, 2, start_round=2, server_state=l2.final_state)
    for a, b in zip(tree_leaves(p_res), tree_leaves(p4)):
        assert torch.equal(a, b)
    assert l_res.losses == l4.losses[2:]
    if l4.final_state is not None:
        for a, b in zip(tree_leaves(l_res.final_state["client"]
                                    if "client" in l4.final_state
                                    else l_res.final_state["global"]),
                        tree_leaves(l4.final_state["client"]
                                    if "client" in l4.final_state
                                    else l4.final_state["global"])):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# round telemetry on the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["fedldf_vmap", "int8_ef", "fedlama"])
def test_cuda_telemetry_round_matches_cpu(cuda, case):
    """One telemetry-on round on the card against the same round on the
    CPU: the same tap keys, selection and comm; the taps within the
    divergence kernel's tolerance (plus one int8 step's share for the EF
    residual norm)."""
    params, _ = _engine_task()
    fl = dataclasses.replace(_engine_fl(case), telemetry=TelemetryConfig())
    rng = np.random.default_rng(0)
    batch = {"images": rng.normal(size=(5, 8, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(5, 8)).astype(np.int32)}
    sizes = np.array([100.0, 150.0, 80.0, 120.0, 100.0], np.float32)
    round_fn = build_round_fn(_loss, UnitMap.build(params), fl)
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = make_strategy(fl).init_state(p, 5)
        outs[str(dev)] = round_fn(p, b, torch.from_numpy(sizes).to(dev),
                                  state)[1]
    m_c, m_g = outs["cpu"], outs["cuda"]
    assert torch.equal(m_g["selection"].cpu(), m_c["selection"])
    assert sorted(m_g["taps"]) == sorted(m_c["taps"])
    for name, c in m_c["taps"].items():
        g = m_g["taps"][name]
        assert g.is_cuda
        rtol = 1e-2 if name == "state_residual_norm" else TOL["rtol"]
        torch.testing.assert_close(g.cpu(), c, rtol=rtol, atol=TOL["atol"])
    for name, c in m_c["comm"].items():
        assert float(m_g["comm"][name]) == pytest.approx(float(c))


@pytest.mark.parametrize("case", ["fedldf_vmap", "int8_ef", "fedlama"])
def test_cuda_telemetry_block_does_not_sync(cuda, case):
    """A telemetry-on 2-round block enqueues without a host sync, and its
    losses, comm, taps and selection come back in one copy."""
    params, data = _engine_task()
    fl = dataclasses.replace(_engine_fl(case), telemetry=TelemetryConfig())
    p = tree_map(lambda l: l.to(cuda), params)
    shards = ClientShards.from_federated(data).to(cuda)
    host_sizes, all_sizes = shards.part_sizes.cpu(), shards.data_sizes()
    run_block = fl_server._build_block_fn(_loss, UnitMap.build(p), fl)

    def carry():
        return (p, make_strategy(fl).init_state(p, fl.num_clients),
                comm_acc_init(cuda))

    draws = KeyedDraws(0)
    run_block(carry(), shards, all_sizes, host_sizes, draws, 0, 2)  # warm
    c0 = carry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, per = run_block(c0, shards, all_sizes, host_sizes, draws, 0, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host, copies = fl_server._pull(per)
    assert copies == 1
    assert host["selection"].shape == (2, 5, 5)
    assert all(t.shape[0] == 2 and bool(torch.isfinite(t).all())
               for t in tree_leaves(host))


def test_cuda_engine_ledger_matches_cpu(cuda, tmp_path):
    """The engine's ledger on the card against the CPU's: the same keys,
    comm and selection, taps within the divergence kernel's tolerance, and
    a peak device memory on the card."""
    params, data = _engine_task()
    recs = {}
    for dev in ("cpu", cuda):
        lp = str(tmp_path / f"{dev}.jsonl")
        fl = dataclasses.replace(_engine_fl("fedldf_vmap"),
                                 telemetry=TelemetryConfig(ledger_path=lp))
        run_training_scan(params, _loss, data, fl, rounds=3, seed=3,
                          device=dev, eval_fn=lambda p: 0.5, eval_every=2)
        recs[str(dev)] = split_runs(read_ledger(lp))[0]["rounds"]
    for c, g in zip(recs["cpu"], recs["cuda"]):
        assert sorted(c) == sorted(g) and c["round"] == g["round"]
        assert c["comm"] == g["comm"] and c["selection"] == g["selection"]
        for name in c["taps"]:
            np.testing.assert_allclose(g["taps"][name], c["taps"][name],
                                       **TOL)
        assert c["mem_peak_bytes"] is None
        assert 0 < g["mem_peak_bytes"] <= torch.cuda.max_memory_allocated()


def test_cuda_device_memory_peak(cuda):
    x = torch.ones(1 << 20, device=cuda)
    peak = device_memory_peak(cuda)
    assert isinstance(peak, int) and peak >= x.numel() * 4
    assert peak == torch.cuda.max_memory_allocated(cuda)


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


# -- the CUDA-core route's tiles (csrc/flash_attention.cu) -----------------
# kTQ query rows a block, kTK keys a tile, and the ring's stages (K, V)
CORE_TQ, CORE_TK, CORE_STAGES = 128, 128, 2
# (hd, dtype, sq, skv, kv_len, group, causal, window)
CORE_CASES = (
    # the query tile's edge, one either side
    [(128, "f32", sq, sq, sq, 2, True, 0)
     for sq in (CORE_TQ - 1, CORE_TQ, CORE_TQ + 1)]
    # kv_len 0 and 1, at a key tile's and at the ring's edge, one either side
    + [(64, "f32", 300, 300, n, 5, causal, 0)
       for n in (0, 1, CORE_TK - 1, CORE_TK, CORE_TK + 1,
                 CORE_STAGES * CORE_TK - 1, CORE_STAGES * CORE_TK,
                 CORE_STAGES * CORE_TK + 1)
       for causal in (False, True)]
    # windows that start inside a key tile
    + [(128, "f32", 300, 300, 300, 8, True, 37),
       (32, "f32", 300, 300, 300, 1, False, 200),
       (64, "f32", 257, 300, 290, 2, True, 130)]
    # every head dim in f32 and the two bf16 ones the route takes, G 1, 2, 5
    # and 8, causal and not
    + [(hd, dn, 200, 200, 200, group, causal, 0)
       for hd, dn in ((16, "f32"), (32, "f32"), (64, "f32"), (128, "f32"),
                      (16, "bf16"), (32, "bf16"))
       for group, causal in ((1, True), (2, False), (5, True), (8, False))])


@pytest.mark.parametrize("case", CORE_CASES,
                         ids=[str(i) for i in range(len(CORE_CASES))])
def test_cuda_flash_core_route_tiles(cuda, case):
    """The CUDA-core kernel against the plain version at its tiles' edges:
    Sq and kv_len one either side of a tile and of the ring, kv_len 0
    (all zeros) and 1, windows inside a tile, G 1 to 8, every head dim."""
    hd, dn, sq, skv, kv_len, group, causal, window = case
    q, k, v = _bshd(cuda, 2, sq, 2 * group, 2, skv, hd, dn,
                    sq + kv_len + group + hd)
    assert tkf.route(DTYPES[dn], sq, hd) == "cuda_core"
    kw = {"causal": causal, "window": window, "kv_len": kv_len}
    got = ops.flash_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    _close(got, ref.flash_attention(q, k, v, **kw), dn)
    if kv_len == 0:
        assert bool((got == 0).all())
    assert ops.launch_counts()["flash_attention_cuda_core"] == 1


@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_flash_core_route_takes_model_views(cuda, hd):
    """q a (B, S, H, hd) view of a fused (B, S, (H + 2 KV)·hd) projection,
    k and v slices of a stacked (2, B, S_max, KV, hd) cache: no copies."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    b, sq, h, kvh = 2, 130, 8, 2
    qkv = torch.randn(b, sq, (h + 2 * kvh) * hd, generator=g, device=cuda)
    q = qkv[..., :h * hd].view(b, sq, h, hd)
    cache = torch.randn(2, b, 160, kvh, hd, generator=g, device=cuda)
    k, v = cache[0][:, :sq], cache[1][:, :sq]
    assert not (q.is_contiguous() or k.is_contiguous())
    for kw in ({"causal": True, "window": 0},
               {"causal": False, "window": 45, "kv_len": 101}):
        _close(ops.flash_attention(q, k, v, **kw),
               ref.flash_attention(q, k, v, **kw), "f32")
    assert ops.launch_counts()["flash_attention_cuda_core"] == 2


def test_cuda_flash_core_rows_are_independent_of_the_launch(cuda):
    """A row's bits depend on its q, the keys it sees and the masks only:
    two launches agree bit for bit, one (b, h) alone (a strided view)
    equals it inside a batch of 8, and the first rows of a shorter query
    equal the same rows of the longer one."""
    b, sq, h, kvh, hd = 8, 300, 4, 2, 128
    q, k, v = _bshd(cuda, b, sq, h, kvh, sq, hd, "f32", 11)
    for kw in ({"causal": True, "window": 0},
               {"causal": False, "window": 50, "kv_len": 250}):
        full = ops.flash_attention(q, k, v, **kw)
        assert torch.equal(full, ops.flash_attention(q, k, v, **kw))
        bi, hi = 5, 3
        alone = ops.flash_attention(
            q[bi:bi + 1, :, hi:hi + 1], k[bi:bi + 1, :, hi // 2:hi // 2 + 1],
            v[bi:bi + 1, :, hi // 2:hi // 2 + 1], **kw)
        assert torch.equal(alone[0, :, 0], full[bi, :, hi])
        shorter = ops.flash_attention(q[:, :CORE_TQ + 37], k, v, **kw)
        assert torch.equal(shorter, full[:, :CORE_TQ + 37])
        _close(full, ref.flash_attention(q, k, v, **kw), "f32")
    assert ops.launch_counts()["flash_attention_cuda_core"] == 8


def test_cuda_flash_core_blocks_fit_without_spills(cuda):
    """Every instantiation keeps its registers (at most 255, nothing
    spilled) and its shared memory (at most 227 KB a block), and a block
    of 8 warps fits an SM."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in tkf.HEAD_DIMS:
            occ = tkf.core_occupancy(hd, dtype)
            assert occ["local_bytes"] == 0 and occ["registers"] <= 255
            assert 0 < occ["smem_bytes"] <= 232_448
            assert occ["blocks_per_sm"] >= 1


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


# ----------------------------------------------------------------------
# LoRA fine-tuning through the kernel (FlashAttentionFn under torch.func)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hd,dtype", [(64, "f32"), (128, "bf16"),
                                      (16, "bf16")])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24)])
def test_cuda_flash_attention_fn_grads_match_plain(cuda, hd, dtype, causal,
                                                   window):
    """vmap(grad) through the kernel (one launch for the 3 clients) against
    autograd of the plain version, client by client."""
    n, b, s, h, kvh = 3, 2, 80, 4, 2
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v, w = (torch.randn(shape, generator=g, device=cuda,
                              dtype=DTYPES[dtype])
                  for shape in ((n, b, s, h, hd), (n, b, s, kvh, hd),
                                (n, b, s, kvh, hd), (n, b, s, h, hd)))

    def loss(attn_fn):
        return lambda q, k, v, w: (attn_fn(q, k, v).float() * w.float()).sum()

    got = torch.func.vmap(torch.func.grad(loss(
        lambda q, k, v: tkf.FlashAttentionFn.apply(q, k, v, causal, window,
                                                   None)),
        argnums=(0, 1, 2)))(q, k, v, w)
    assert ops.launch_counts()["flash_attention"] == 1
    for i in range(n):
        leaves = [t[i].clone().requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention(*leaves, causal=causal, window=window)
        (out.float() * w[i].float()).sum().backward()
        for got_g, t in zip(got, leaves):
            scale = float(t.grad.float().abs().max())
            assert got_g.dtype == t.dtype
            err = float((got_g[i].float() - t.grad.float()).abs().max())
            assert err <= FLASH_TOL[dtype] * max(scale, 1.0), err


TINY_LM = dict(name="tiny", family="dense", d_model=128, num_layers=2,
               num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=128,
               param_dtype="float32", compute_dtype="float32")


def _lora_task(cfg):
    from repro_torch.data import lm_federated, make_lm_dataset
    from repro_torch.models.lora import inject_lora, lora_partition
    tokens, domains = make_lm_dataset(num_sequences=64, seq_len=33,
                                      vocab=cfg.vocab_size, num_domains=4,
                                      seed=0)
    params = inject_lora(
        ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        4, torch.Generator().manual_seed(1))
    # a non-zero b, so the first round already moves every factor
    for lora in (params["blocks"]["attn"]["lora"],
                 params["blocks"]["mlp"]["lora"]):
        for f in lora.values():
            f["b"] = 0.05 * torch.randn(f["b"].shape,
                                        generator=torch.Generator()
                                        .manual_seed(2))
    return params, lm_federated(tokens, domains, 4), lora_partition(params)


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_cuda_lora_round_matches_cpu(cuda, mode):
    """A partitioned fedldf run of 2 rounds (hd 32, f32: the CUDA-core
    route) on the card against the CPU: the frozen base untouched, the
    adapters within 2e-5, one kernel launch a layer for the K clients in
    vmap mode (two passes of K in scan mode)."""
    cfg = ModelConfig(**TINY_LM)
    params, data, part = _lora_task(cfg)
    fl = FLConfig(num_clients=4, clients_per_round=2, top_n=1, mode=mode,
                  batch_per_client=4, partition=part)
    loss = ttf.make_lm_loss(cfg)
    out_c, log_c = run_training_scan(params, loss, data, fl, rounds=2,
                                     device="cpu")
    ops.reset_launch_counts()
    params_g = tree_map(lambda l: l.to(cuda), params)
    out_g, log_g = run_training_scan(params_g, loss, data, fl, rounds=2,
                                     device=cuda)
    per_round = cfg.num_layers * (1 if mode == "vmap" else 4)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * per_round
    assert counts["flash_attention_cuda_core"] == 2 * per_round
    np.testing.assert_allclose(log_g.losses, log_c.losses, atol=1e-5,
                               rtol=0)
    _, frozen0 = part.split(params_g)
    _, frozen1 = part.split(out_g)
    for a, b in zip(tree_leaves(frozen0), tree_leaves(frozen1)):
        assert a is b
    for a, c in zip(tree_leaves(out_g), tree_leaves(out_c)):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=EQUIV_TOL)


def test_cuda_remat_blocks_round(cuda):
    """remat_blocks recomputes each block in the backward pass through the
    kernel: the same adapters as without, and more flash-attention
    launches (the recompute's)."""
    cfg = ModelConfig(**TINY_LM)
    params, data, part = _lora_task(cfg)
    fl = FLConfig(num_clients=4, clients_per_round=2, top_n=1,
                  batch_per_client=4, partition=part)
    outs, launches = [], []
    for remat in (False, True):
        ops.reset_launch_counts()
        c = dataclasses.replace(cfg, remat_blocks=remat)
        outs.append(run_training_scan(
            tree_map(lambda l: l.to(cuda), params), ttf.make_lm_loss(c),
            data, fl, rounds=2, device=cuda))
        launches.append(ops.launch_counts()["flash_attention"])
    assert launches == [2 * cfg.num_layers, 4 * cfg.num_layers]
    (p0, l0), (p1, l1) = outs
    np.testing.assert_allclose(l1.losses, l0.losses, atol=1e-6, rtol=0)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        torch.testing.assert_close(a, b, rtol=0, atol=EQUIV_TOL)


# -- the ssm and hybrid kinds ------------------------------------------------
@pytest.fixture
def no_tf32():
    """f32 products in f32 (not TF32) for the duration of a test."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.parametrize("s", [300, 512])
def test_cuda_ssd_chunked_matches_its_recurrence(cuda, no_tf32, s):
    """hymba-1.5b's SSD at its widths (d 1600, 50 heads of 64, state 16,
    chunk 128) in f32 on the card: ssd_fwd (a ragged last chunk at 300,
    four chunks at 512) against ssd_step token by token from a zero cache,
    within 1e-4 of max |y|."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"), param_dtype="float32",
                              compute_dtype="float32")
    p = tssm.init_ssm(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    x = torch.randn(2, s, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s))
    with torch.inference_mode():
        y, cache = tssm.ssd_fwd(p, x, cfg, return_cache=True)
        step = tssm.init_ssm_cache(cfg, 2, torch.float32, cuda)
        ys = []
        for t in range(s):
            o, step = tssm.ssd_step(p, x[:, t:t + 1], step, cfg)
            ys.append(o)
    tol = 1e-4 * float(y.abs().max())
    torch.testing.assert_close(torch.cat(ys, dim=1), y, rtol=0, atol=tol)
    for key in ("state", "conv"):
        torch.testing.assert_close(step[key], cache[key], rtol=0,
                                   atol=1e-4 * float(cache[key].abs().max()))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("route", ["tc", "decode", "cuda_core"])
def test_cuda_flash_attention_hymba_shapes(cuda, route):
    """25 query heads over 5 KV heads (G = 5) at hd 64, as hymba-1.5b
    attends: a causal prefill on the tensor cores (bf16) and the CUDA
    cores (f32), and a decode step (G·Sq = 5 rows) over a filled prefix in
    both dtypes."""
    if route == "decode":
        for dtype in ("bf16", "f32"):
            q, k, v = _bshd(cuda, 2, 1, 25, 5, 600, 64, dtype, 11)
            for kv_len in (1, 129, 600):
                _close(ops.flash_attention(q, k, v, causal=False,
                                           kv_len=kv_len),
                       ref.flash_attention(q, k, v, causal=False,
                                           kv_len=kv_len), dtype)
        assert ops.launch_counts()["flash_attention_decode"] == 6
        return
    dtype = "bf16" if route == "tc" else "f32"
    q, k, v = _bshd(cuda, 2, 300, 25, 5, 300, 64, dtype, 12)
    assert tkf.route(q.dtype, 300, 64) == route
    _close(ops.flash_attention(q, k, v, causal=True),
           ref.flash_attention(q, k, v, causal=True), dtype)
    assert ops.launch_counts()[f"flash_attention_{route}"] == 1


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_cuda_ssm_and_hybrid_serving_match_cpu(cuda, no_tf32, family):
    """A small model of each kind (the hybrid at G = 5, hd 64) in f32:
    prefill and 4 decode steps on the card equal forward's logits there
    and the CPU's; the hybrid launches the kernel once a layer a pass, the
    ssm kind never."""
    cfg = ModelConfig(name="t-" + family, family=family, num_layers=2,
                      d_model=128, num_heads=10, num_kv_heads=2, head_dim=64,
                      d_ff=256, vocab_size=97, ssm_state=16, ssm_head_dim=32,
                      ssm_chunk=8)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 97, size=(2, 24)))
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        t = toks.to(dev)
        with torch.inference_mode():
            full, _ = ttf.forward(p, cfg, t)
            lg, cache = tdec.prefill(p, cfg, t[:, :20], max_len=24)
            steps = [lg]
            for i in range(20, 24):
                lg, cache = tdec.decode_step(p, cfg, t[:, i:i + 1], cache)
                torch.testing.assert_close(lg, full[:, i], rtol=1e-4,
                                           atol=1e-4)
                steps.append(lg)
        outs[str(dev)] = torch.stack(steps).cpu()
        assert set(cache) == ({"pos", "ssm_conv", "ssm_state"}
                              if family == "ssm" else
                              {"pos", "k", "v", "ssm_conv", "ssm_state"})
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)
    counts = ops.launch_counts()
    layers = cfg.num_layers if family == "hybrid" else 0
    assert counts["flash_attention_cuda_core"] == 2 * layers   # fwd, prefill
    assert counts["flash_attention_decode"] == 4 * layers
    assert counts["flash_attention"] == 6 * layers


def test_cuda_stacked_grads_equal_the_slice_form(cuda, no_tf32,
                                                 monkeypatch):
    """An 8-layer reduced hybrid in f32, one fine-tune step's gradient on
    the card (``vjp`` of ``lm_loss``): every leaf equal to the one of the
    former slice a layer (``tests/test_torch_stack_grad.py``), and the
    backward's peak ``max_memory_allocated`` no higher than that form's."""
    from test_torch_stack_grad import batch_for, slice_layers, small_model
    cfg, params = small_model("hybrid", layers=8)
    params = tree_map(lambda l: l.to(cuda), params)
    batch = batch_for(cfg, device=cuda, seq=64)     # the CUDA-core route

    def step():
        loss, vjp_fn = torch.func.vjp(
            lambda p: ttf.lm_loss(p, cfg, batch), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (g,) = vjp_fn(torch.ones_like(loss))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        return tree_map(lambda l: l.cpu(), g), peak

    got, peak = step()
    monkeypatch.setattr(ttf, "tree_unbind", slice_layers)
    want, peak_slices = step()
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert peak <= peak_slices
    assert ops.launch_counts()["flash_attention_cuda_core"] == 2 * 8


# -- the moe kind -------------------------------------------------------------
TINY_MOE = dict(name="t-moe", family="moe", num_layers=2, d_model=128,
                num_heads=4, num_kv_heads=4, head_dim=64, d_ff=0,
                vocab_size=97, num_experts=4, moe_top_k=2, moe_d_ff=64,
                num_shared_experts=1, capacity_factor=8.0,
                param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_cuda_moe_fwd_matches_the_loop_without_a_sync(cuda, no_tf32, cf):
    """deepseek-moe-16b's layer at its widths (64 experts of 1408, top-6,
    2 shared) in f32 over 4 × 256 tokens, enqueued under
    ``set_sync_debug_mode("error")`` (a host sync raises), against the
    per-expert loop within 1e-4 of max |out|; at 0.5 choices must drop."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              param_dtype="float32", compute_dtype="float32",
                              capacity_factor=cf)
    p = tmoe.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg,
                      cuda)
    x = torch.randn(4, 256, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = tmoe.moe_fwd(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_aux, dropped = moe_loop(p, x, cfg)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=1e-5)
    if cf == 0.5:
        assert dropped > 0
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("route", ["tc", "decode"])
def test_cuda_flash_attention_deepseek_shapes(cuda, route):
    """16 query heads over 16 KV heads (G = 1) at hd 128, as
    deepseek-moe-16b attends: a causal bf16 prefill on the tensor cores,
    and a decode step over a filled prefix in both dtypes."""
    if route == "decode":
        for dtype in ("bf16", "f32"):
            q, k, v = _bshd(cuda, 2, 1, 16, 16, 600, 128, dtype, 13)
            for kv_len in (1, 129, 600):
                _close(ops.flash_attention(q, k, v, causal=False,
                                           kv_len=kv_len),
                       ref.flash_attention(q, k, v, causal=False,
                                           kv_len=kv_len), dtype)
        assert ops.launch_counts()["flash_attention_decode"] == 6
        return
    q, k, v = _bshd(cuda, 2, 300, 16, 16, 300, 128, "bf16", 14)
    assert tkf.route(q.dtype, 300, 128) == "tc"
    _close(ops.flash_attention(q, k, v, causal=True),
           ref.flash_attention(q, k, v, causal=True), "bf16")
    assert ops.launch_counts()["flash_attention_tc"] == 1


def test_cuda_moe_serving_matches_cpu(cuda, no_tf32):
    """A small moe model (G = 1, hd 64, a capacity no call fills) in f32:
    prefill and 4 decode steps on the card equal forward's logits there
    and the CPU's, aux too; the kernel launches once a layer a pass."""
    cfg = ModelConfig(**TINY_MOE)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 97, size=(2, 24)))
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        t = toks.to(dev)
        with torch.inference_mode():
            full, aux = ttf.forward(p, cfg, t)
            lg, cache = tdec.prefill(p, cfg, t[:, :20], max_len=24)
            steps = [lg]
            for i in range(20, 24):
                lg, cache = tdec.decode_step(p, cfg, t[:, i:i + 1], cache)
                torch.testing.assert_close(lg, full[:, i], rtol=1e-4,
                                           atol=1e-4)
                steps.append(lg)
        outs[str(dev)] = (torch.stack(steps).cpu(), aux.cpu())
        assert set(cache) == {"pos", "k", "v"}
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=1e-5,
                               atol=1e-5)
    counts = ops.launch_counts()
    assert counts["flash_attention_cuda_core"] == 2 * cfg.num_layers
    assert counts["flash_attention_decode"] == 4 * cfg.num_layers
    assert counts["flash_attention"] == 6 * cfg.num_layers


@pytest.mark.parametrize("remat", [False, True])
def test_cuda_moe_vmap_grad_matches_cpu(cuda, no_tf32, remat):
    """vmap(grad_and_value) of the moe lm_loss over 2 clients' batches
    (the capacity factor 1.25: choices drop) on the card through
    ``FlashAttentionFn`` against the CPU: losses within 1e-5, every leaf's
    gradient within 2e-5."""
    cfg = ModelConfig(**{**TINY_MOE, "capacity_factor": 1.25,
                         "remat_blocks": remat})
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    batch = {n: torch.from_numpy(rng.integers(0, 97, size=(2, 2, 16)))
             for n in ("tokens", "labels")}
    fn = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: ttf.lm_loss(p, cfg, b)), in_dims=(None, 0))
    g_c, l_c = fn(params, batch)
    g_g, l_g = fn(tree_map(lambda l: l.to(cuda), params),
                  tree_map(lambda l: l.to(cuda), batch))
    torch.testing.assert_close(l_g.cpu(), l_c, rtol=0, atol=1e-5)
    for a, c in zip(tree_leaves(g_g), tree_leaves(g_c)):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=EQUIV_TOL)
    assert ops.launch_counts()["flash_attention"] == \
        cfg.num_layers * (2 if remat else 1)


# -- granite-4.0-h: the held experts' share and the patterned stack ---------
def _granite_f32(**kw):
    return dataclasses.replace(get_config("granite-4.0-h-small"),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


def test_cuda_granite_moe_share_matches_the_loop_without_a_sync(cuda,
                                                                no_tf32):
    """granite-4.0-h-small's expert layer at its widths (9 of 72 experts
    of 768, top-10, a shared expert of 1536, d 4096) in f32 over T = 2 ×
    1024 tokens, dropless, enqueued under ``set_sync_debug_mode("error")``
    (a host sync raises), against the benchmark reference's per-expert
    loop within 1e-4 of max |out|."""
    from bench import spec
    ref = spec.reference("granite-4.0-h-small")
    cfg = _granite_f32(num_experts=9, router_experts=72)
    p = tmoe.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg,
                      cuda)
    x = torch.randn(2, 1024, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = tmoe.moe_fwd(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    z = ref._dims(dataclasses.asdict(cfg))
    want, want_aux = ref.experts(p, x, z, 0, "f32")
    sh = p["shared"]
    want = want + ref._swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"],
                              "f32")
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=1e-5)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cuda_granite_block_does_not_sync(cuda, no_tf32):
    """A 2-round scan block of the small granite model (both kinds of
    layer, the held experts, remat) enqueues without one host sync."""
    from bench import data as bench_data
    cfg = dataclasses.replace(_granite_f32().reduced(), num_experts=4,
                              router_experts=8, remat_blocks=True)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    ds = bench_data.tokens({"seq_len": 16, "num_sequences": 16,
                            "num_domains": 4, "eval_sequences": 2,
                            "partition": "domain"}, cfg.vocab_size, 4, 0,
                           cuda)
    shards = ClientShards(xs=ds.xs, ys=ds.ys, part_idx=ds.part_idx,
                          part_sizes=ds.part_sizes, x_key="tokens",
                          y_key="labels")
    fl = FLConfig(num_clients=4, clients_per_round=2, top_n=1,
                  batch_per_client=2, mode="scan")
    loss = ttf.make_lm_loss(cfg)
    host_sizes, all_sizes = shards.part_sizes.cpu(), shards.data_sizes()
    run_block = fl_server._build_block_fn(loss, UnitMap.build(params), fl)

    def carry():
        return (params, make_strategy(fl).init_state(params, 4),
                comm_acc_init(cuda))

    draws = KeyedDraws(0)
    run_block(carry(), shards, all_sizes, host_sizes, draws, 0, 2)  # warm
    c0 = carry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (_, _, acc), per = run_block(c0, shards, all_sizes, host_sizes,
                                     draws, 0, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(per["loss"]).all())
    assert float(acc["rounds"]) == 2.0


# -- the enc-dec kinds -------------------------------------------------------
TINY_ENCDEC = dict(name="t-audio", family="audio", num_layers=2,
                   encoder_layers=2, d_model=128, num_heads=4,
                   num_kv_heads=4, head_dim=64, d_ff=256, vocab_size=97,
                   frontend_dim=48, param_dtype="float32",
                   compute_dtype="float32")


@pytest.mark.parametrize("route", ["tc", "decode"])
def test_cuda_flash_attention_seamless_shapes(cuda, route):
    """16 query heads over 16 KV heads (G = 1) at hd 64, as
    seamless-m4t-large-v2 attends (batch 1): a non-causal bf16 prefill
    over 2048 frames and a cross prefill over a ragged 1500 on the tensor
    cores; a decode step over 2080 slots at kv_len 2049 and a cross
    decode step over 2048 frames at kv_len 2048, in both dtypes."""
    if route == "decode":
        for dtype in ("bf16", "f32"):
            for skv, kv_len in ((2080, 2049), (2048, 2048)):
                q, k, v = _bshd(cuda, 1, 1, 16, 16, skv, 64, dtype, 15)
                _close(ops.flash_attention(q, k, v, causal=False,
                                           kv_len=kv_len),
                       ref.flash_attention(q, k, v, causal=False,
                                           kv_len=kv_len), dtype)
        assert ops.launch_counts()["flash_attention_decode"] == 4
        return
    for skv in (2048, 1500):
        q, k, v = _bshd(cuda, 1, 2048, 16, 16, skv, 64, "bf16", 16)
        _close(ops.flash_attention(q, k, v, causal=False),
               ref.flash_attention(q, k, v, causal=False), "bf16")
    assert ops.launch_counts()["flash_attention_tc"] == 2


@pytest.mark.parametrize("dtype,frames_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_cuda_encdec_serving_matches_cpu(cuda, no_tf32, dtype, frames_dtype):
    """A small enc-dec model (G = 1, hd 64) over 24 frames: prefill and 4
    decode steps on the card against the CPU (f32 within 1e-4, bf16 within
    3e-2 of max |logit|), in f32 also against forward on the card; the
    kernel launches 3 × L times a prefill (encoder, decoder, cross; bf16
    frames: all on the tensor cores; f32 frames into the bf16 model: the
    encoder and the cross on the CUDA cores in f32, the decoder's self on
    the tensor cores) and 2 × L a decode step (split-KV), and the cross
    K/V stay as the prefill wrote them."""
    cfg = ModelConfig(**{**TINY_ENCDEC, "param_dtype": dtype,
                         "compute_dtype": dtype})
    layers = cfg.num_layers
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 97, size=(2, 24)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 24, 48), dtype=np.float32)).to(getattr(torch, frames_dtype))
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda l: l.to(dev), params)
        t, fr = toks.to(dev), frames.to(dev)
        with torch.inference_mode():
            if dtype == "float32":
                full, _ = ttf.forward(p, cfg, t, fr)
            ops.reset_launch_counts()
            lg, cache = tdec.prefill(p, cfg, t[:, :20], fr, max_len=24)
            cross = (cache["cross_k"].clone(), cache["cross_v"].clone())
            pre = ops.launch_counts()
            steps = [lg]
            for i in range(20, 24):
                lg, cache = tdec.decode_step(p, cfg, t[:, i:i + 1], cache)
                if dtype == "float32":
                    torch.testing.assert_close(lg, full[:, i], rtol=1e-4,
                                               atol=1e-4)
                steps.append(lg)
        assert torch.equal(cache["cross_k"], cross[0])
        assert torch.equal(cache["cross_v"], cross[1])
        outs[str(dev)] = torch.stack(steps).float().cpu()
        assert set(cache) == {"pos", "k", "v", "cross_k", "cross_v"}
    tol = (1e-4 if dtype == "float32" else
           3e-2 * float(outs["cpu"].abs().max()))
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=tol)
    if dtype == frames_dtype:
        route = "cuda_core" if dtype == "float32" else "tc"
        assert pre[f"flash_attention_{route}"] == 3 * layers
    else:
        assert (pre["flash_attention_cuda_core"],
                pre["flash_attention_tc"]) == (2 * layers, layers)
    assert pre["flash_attention"] == 3 * layers
    counts = ops.launch_counts()
    assert counts["flash_attention_decode"] == 4 * 2 * layers
    assert counts["flash_attention"] == 3 * layers + 4 * 2 * layers


@pytest.mark.parametrize("remat", [False, True])
def test_cuda_encdec_vmap_grad_matches_cpu(cuda, no_tf32, remat):
    """vmap(grad_and_value) of the enc-dec lm_loss over 2 clients'
    batches (tokens and 24 frames) on the card through
    ``FlashAttentionFn`` against the CPU: losses within 1e-5, every leaf's
    gradient within 2e-5; one launch an attention (encoder, decoder,
    cross) for both clients, twice under remat."""
    cfg = ModelConfig(**{**TINY_ENCDEC, "remat_blocks": remat})
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    batch = {n: torch.from_numpy(rng.integers(0, 97, size=(2, 2, 20)))
             for n in ("tokens", "labels")}
    batch["enc_inputs"] = torch.from_numpy(rng.standard_normal(
        (2, 2, 24, 48), dtype=np.float32))
    fn = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: ttf.lm_loss(p, cfg, b)), in_dims=(None, 0))
    g_c, l_c = fn(params, batch)
    g_g, l_g = fn(tree_map(lambda l: l.to(cuda), params),
                  tree_map(lambda l: l.to(cuda), batch))
    torch.testing.assert_close(l_g.cpu(), l_c, rtol=0, atol=1e-5)
    for a, c in zip(tree_leaves(g_g), tree_leaves(g_c)):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=EQUIV_TOL)
    attentions = cfg.encoder_layers + 2 * cfg.num_layers
    assert ops.launch_counts()["flash_attention"] == \
        attentions * (2 if remat else 1)


# ----------------------------------------------------------------------
# the client mesh: a world of 2 gloo ranks on the card
# ----------------------------------------------------------------------
def test_cuda_mesh_gloo_world_stages_and_matches_one_device(cuda, tmp_path):
    """Two gloo ranks (sharing a card where there is one): the four
    collectives on CUDA tensors through the pinned staging buffer, then
    fedldf and setting A on the mesh against the engine on one device,
    every rank's bits equal, and 1 ``sqdiff_rowsum`` (and in A 1
    ``fused_uplink_ef``) a rank a round. fedldf's every round is held to
    the one-device round from the same params (2e-5: the reduce's f32
    order, which a diverging trajectory amplifies from round to round);
    A's two rounds to the one-device run within 2e-5 plus one int8
    step."""
    import torch_mesh_worker as w
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.launch.mesh import spawn
    train, _ = make_image_dataset(num_train=320, num_test=16, seed=2)
    parts = iid_partition(train.ys, w.N, seed=0)
    params = cnn.init_params(w.CFG, torch.Generator().manual_seed(0), "cpu")
    task = {"params": params_to_numpy(params), "xs": train.xs,
            "ys": train.ys, "parts": parts}
    ranks = spawn(w.card_world, 2, (task,), backend="gloo",
                  store_dir=str(tmp_path))
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(2)]
    for r, res in enumerate(ranks):
        assert (res["backend"], res["stage"]) == ("gloo", True)
        assert res["device"].startswith("cuda")
        np.testing.assert_array_equal(res["gather"], np.concatenate(x))
        np.testing.assert_array_equal(res["reduce"], x[0] + x[1])
        np.testing.assert_array_equal(res["group"], x[0] + x[1])
        np.testing.assert_array_equal(res["shift"], x[1 - r])
        np.testing.assert_allclose(res["psum"], res["psum_want"],
                                   atol=1e-6)
        ops_, bytes_, secs = res["counts"]["staged"]
        assert ops_ >= 5 and bytes_ > 0 and secs > 0
    data = FederatedData(train.xs, train.ys, parts)
    for name, comp in (("flat", None), ("A", w.SETTING_A)):
        p1, log1 = run_training_scan(params, w.loss_fn, data,
                                     w.fl_config(compression=comp),
                                     rounds=2, seed=0, device="cuda")
        one = params_to_numpy(p1)
        for res in ranks:
            run = res[name]
            assert run["losses"] == ranks[0][name]["losses"]
            for a, b in zip(tree_leaves(run["params"]),
                            tree_leaves(ranks[0][name]["params"])):
                np.testing.assert_array_equal(a, b)
            assert run["uplink"] == log1.meter.uplink_bytes
            if comp is None:
                starts = [params_to_numpy(params)] + run["per_round"][:-1]
                for t, (p_t, p_next) in enumerate(zip(starts,
                                                      run["per_round"])):
                    pt, lt = run_training_scan(
                        params_from_numpy(p_t, "cuda"), w.loss_fn, data,
                        w.fl_config(), rounds=1, start_round=t, seed=0,
                        device="cuda")
                    assert abs(run["losses"][t] - lt.losses[0]) <= 1e-5
                    for a, b in zip(tree_leaves(p_next),
                                    tree_leaves(params_to_numpy(pt))):
                        np.testing.assert_allclose(a, b, atol=EQUIV_TOL,
                                                   rtol=0)
            else:
                np.testing.assert_allclose(run["losses"], log1.losses,
                                           atol=1e-5, rtol=0)
                for key in one:
                    step = max(float(np.abs(v).max())
                               for v in tree_leaves(one[key])) / 127.0
                    for a, b in zip(tree_leaves(run["params"][key]),
                                    tree_leaves(one[key])):
                        np.testing.assert_allclose(
                            a, b, atol=EQUIV_TOL + step, rtol=0)
            want = {"sqdiff_rowsum": 2}
            if comp is not None:
                want["fused_uplink_ef"] = 2
            assert run["launches"] == want


# ----------------------------------------------------------------------
# the 2-D ('clients', 'model') mesh: a 1 x 2 grid of 2 gloo ranks
# ----------------------------------------------------------------------
def test_cuda_grid_1x2_halves_the_bytes_at_rest_and_matches_one_rank(
        cuda, tmp_path):
    """A 1 × 2 grid of 2 gloo ranks on the card, the MLP of
    ``tests/test_model_axis.py`` at N = 8: a rank's params and EF store at
    rest (``torch.cuda.memory_allocated`` deltas, which round every tensor
    up to 512 B) are half the 1-rank mesh's but for the replicated 1-D
    leaves; setting A (int8 + EF) through the engine gives the 1-rank
    mesh's bits (C = 1: gather and slice only move data), every rank the
    same, 1 ``sqdiff_rowsum`` and 1 ``fused_uplink_ef`` a rank a round."""
    import torch_model_axis_worker as wg
    from repro_torch.launch.mesh import spawn
    train, _ = make_image_dataset(num_train=320, num_test=16, seed=1)
    parts = iid_partition(train.ys, wg.N, seed=0)
    g = torch.Generator().manual_seed(0)
    params = {"l1": {"w": torch.randn(3072, 16, generator=g) * 0.02,
                     "b": torch.zeros(16)},
              "head": {"w": torch.randn(16, 10, generator=g) * 0.1,
                       "b": torch.zeros(10)}}
    task = {"params": {k: {n: v.numpy() for n, v in d.items()}
                       for k, d in params.items()},
            "xs": train.xs, "ys": train.ys, "parts": parts}
    ranks = spawn(wg.card_grid, 2, (task,), backend="gloo",
                  store_dir=str(tmp_path))

    def rounded(n):
        return -(-n // 512) * 512
    # the replicated 1-D leaves: the params' biases and the store's rows
    rep = (rounded(16 * 4) + rounded(10 * 4),
           rounded(wg.N * 16 * 4) + rounded(wg.N * 10 * 4))
    for res in ranks:
        assert res["shape"] == {"clients": 1, "model": 2} and res["stage"]
        for grid_b, one_b, rep_b in zip(res["grid"], res["one"], rep):
            assert grid_b == (one_b - rep_b) // 2 + rep_b
        run, one = res["grid_run"], res["one_run"]
        assert run["losses"] == one["losses"]
        assert run["uplink"] == one["uplink"]
        for a, b in zip(tree_leaves(run["params"]),
                        tree_leaves(ranks[0]["one_run"]["params"])):
            np.testing.assert_array_equal(a, b)
        assert run["launches"] == {"sqdiff_rowsum": 2, "fused_uplink_ef": 2}
        assert run["state"]["residual"]["l1"]["w"].shape == (wg.N, 1536, 16)
