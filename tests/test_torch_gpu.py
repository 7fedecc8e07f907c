"""On the card: the port's CUDA kernels against their plain PyTorch versions,
and a round on the card against the same round on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.units import UnitMap, tree_leaves, tree_map  # noqa: E402
from repro_torch.data import (FederatedData, iid_partition,  # noqa: E402
                              make_image_dataset)
from repro_torch.federated import (FLConfig, build_round_fn,  # noqa: E402
                                   run_training)
from repro_torch.kernels import aggregate as tka  # noqa: E402
from repro_torch.kernels import divergence as tkd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

pytestmark = pytest.mark.gpu

SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]                  # tests/test_kernels.py:18
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"rtol": 3e-3, "atol": 1e-5}              # tests/test_kernels.py:33,45
EQUIV_TOL = 2e-5                  # benchmarks/round_engine_bench.py:59
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
    assert ops.launch_counts() == {"sqdiff_rowsum": 0,
                                   "masked_accumulate": 0}


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
    # scan mode: one launch per leaf, client and round
    assert ops.launch_counts()["masked_accumulate"] == \
        2 * 5 * len(tree_leaves(params))
