"""Port kernels: the plain PyTorch versions against the reference's jnp
oracles and its Pallas kernels (interpret mode), and the device dispatch.
The CUDA kernels themselves are held to the plain versions on the card in
tests/test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import aggregate as jka  # noqa: E402
from repro.kernels import divergence as jkd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import aggregate as tka  # noqa: E402
from repro_torch.kernels import divergence as tkd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"rtol": 3e-3, "atol": 1e-5}   # tests/test_kernels.py:33,45


def _pair(arr, dtype_name):
    """The same f32 numpy values as a jnp and a torch array of one dtype
    (both round f32 -> bf16 to nearest even, so the inputs are equal)."""
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sqdiff_rowsum_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    ja, ta = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    jb, tb = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    out = ops.sqdiff_rowsum(ta, tb)
    assert out.shape == (shape[0],) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jref.sqdiff_rowsum(ja, jb), **TOL)
    np.testing.assert_allclose(
        out.numpy(), jkd.sqdiff_rowsum(ja, jb, interpret=True), **TOL)
    assert ops.launch_counts()["sqdiff_rowsum"] == 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_accumulate_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(7 + sum(shape))
    ja, ta = _pair(rng.normal(size=shape).astype(np.float32), "f32")
    jx, tx = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    jw, tw = _pair(rng.normal(size=shape[:1]).astype(np.float32), "f32")
    out = ops.masked_accumulate(ta, tx, tw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               jref.masked_accumulate(ja, jx, jw), **TOL)
    np.testing.assert_allclose(
        out.numpy(), jka.masked_accumulate(ja, jx, jw, interpret=True), **TOL)
    assert ops.launch_counts()["masked_accumulate"] == 0


@pytest.mark.parametrize("r,c,seed", [
    (1, 1, 0), (1, 300, 1), (17, 1, 2), (5, 129, 3), (8, 257, 12345),
])
def test_sqdiff_rowsum_property_cases(r, c, seed):
    """Zero difference gives zero; a difference of 1 everywhere gives C."""
    a = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(r, c)).astype(np.float32))
    np.testing.assert_allclose(ops.sqdiff_rowsum(a, a).numpy(), np.zeros(r),
                               atol=1e-6)
    np.testing.assert_allclose(ops.sqdiff_rowsum(a, a + 1.0).numpy(),
                               np.full(r, float(c)), rtol=1e-4)


@pytest.mark.parametrize("r,c,w0,seed", [
    (1, 1, -2.0, 0), (1, 200, 0.5, 1), (9, 1, 2.0, 2), (4, 100, -0.75, 77),
    (7, 63, 1.0, 31337),
])
def test_masked_accumulate_property_cases(r, c, w0, seed):
    """w = 0 rows leave acc unchanged; w scales linearly."""
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32))
    out = ops.masked_accumulate(acc, x, torch.full((r,), w0))
    np.testing.assert_allclose(out.numpy(), acc.numpy() + w0 * x.numpy(),
                               rtol=1e-4, atol=1e-5)
    zero = ops.masked_accumulate(acc, x, torch.zeros(r))
    np.testing.assert_allclose(zero.numpy(), acc.numpy(), atol=1e-6)


@pytest.mark.parametrize("k,r,c", [(1, 1, 37), (5, 1, 1000), (3, 4, 129),
                                   (20, 1, 2049)])
def test_sqdiff_rowsum_broadcast_b_matches_per_client_loop(k, r, c):
    """The client-stacked call — a (K·R, C), b (R, C) broadcast over K —
    equals K separate 2-D calls, and the reference per client."""
    rng = np.random.default_rng(k * 100 + c)
    a = rng.normal(size=(k, r, c)).astype(np.float32)
    b = rng.normal(size=(r, c)).astype(np.float32)
    batched = ops.sqdiff_rowsum(torch.from_numpy(a.reshape(k * r, c)),
                                torch.from_numpy(b)).numpy().reshape(k, r)
    for i in range(k):
        np.testing.assert_array_equal(
            batched[i], ops.sqdiff_rowsum(torch.from_numpy(a[i]),
                                          torch.from_numpy(b)).numpy())
        np.testing.assert_allclose(
            batched[i], jref.sqdiff_rowsum(jnp.asarray(a[i]),
                                           jnp.asarray(b)), **TOL)


def test_masked_accumulate_out_is_acc_writes_in_place():
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    w = torch.tensor([0.5, 0.0, -1.0])
    want = acc.numpy() + w.numpy()[:, None] * x.numpy()
    out = ops.masked_accumulate(acc, x, w, out=acc)
    assert out.data_ptr() == acc.data_ptr()
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    a, b = torch.ones(3, 100), torch.zeros(3, 100)
    np.testing.assert_allclose(ops.sqdiff_rowsum(a, b).numpy(),
                               np.full(3, 100.0))
    ops.masked_accumulate(a, b, torch.ones(3), out=a)
    assert ops.launch_counts() == {"sqdiff_rowsum": 0,
                                   "masked_accumulate": 0}


@pytest.mark.parametrize("launch", [
    lambda t: tkd.sqdiff_rowsum(t, t),
    lambda t: tka.masked_accumulate(t, t, t[:, 0].contiguous()),
], ids=["sqdiff_rowsum", "masked_accumulate"])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    """The CUDA launchers never fall back: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.ones(2, 8))
    assert ops.launch_counts() == {"sqdiff_rowsum": 0,
                                   "masked_accumulate": 0}
