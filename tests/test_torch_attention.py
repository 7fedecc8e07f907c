"""The port's attention against the JAX package on the CPU: the plain
flash attention against the Pallas kernel (interpret mode), ``attend``
against ``repro.models.attention.attend`` on both of its branches, and
RoPE / M-RoPE. The CUDA kernel is held to the plain version on the card in
tests/test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import ref_attention as jref_attention  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tkf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# tests/test_flash_kernel.py CASES:
# (bh, bkv, sq, skv, hd, causal, window, tq, tk)
CASES = [
    (4, 2, 64, 64, 32, True, 0, 16, 32),
    (2, 2, 100, 100, 32, True, 0, 32, 32),
    (6, 2, 48, 48, 16, True, 7, 16, 16),
    (2, 1, 33, 65, 64, False, 0, 16, 32),
    (8, 1, 40, 40, 128, True, 0, 8, 128),
]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}            # tests/test_flash_kernel.py:37
ATTEND_TOL = {"rtol": 2e-4, "atol": 2e-5}    # test_decode_consistency.py:82


def _pair(arr, dtype="f32"):
    """The same numpy values as a jnp and a torch array of one dtype (both
    round f32 -> bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _qkv(rng, q_shape, kv_shape, dtype="f32"):
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    return zip(*(_pair(a, dtype) for a in arrs))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_flash_matches_pallas_kernel(case, dtype):
    bh, bkv, sq, skv, hd, causal, window, tq, tk = case
    rng = np.random.default_rng(sum(case[:5]))
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (bh, sq, hd), (bkv, skv, hd),
                                        dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, tq=tq, tk=tk,
                  interpret=True)
    got = ops.flash_attention(tq_, tk_, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (bh, sq, hd)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("kv_len", [1, 17, 40])
def test_plain_flash_kv_len_is_the_pallas_pad_mask(kv_len):
    """``kv_len`` masks keys at or past it: the Pallas kernel run on the
    first ``kv_len`` keys alone (it pads them with exactly this mask)."""
    rng = np.random.default_rng(kv_len)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (4, 5, 32), (2, 48, 32))
    want = jflash(jq, jk[:, :kv_len], jv[:, :kv_len], causal=False,
                  interpret=True)
    got = ref.flash_attention(tq_, tk_, tv, causal=False, kv_len=kv_len)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_fully_masked_rows_give_zero_as_the_pallas_kernel():
    """A row with no visible key: the Pallas kernel gives 0 (not NaN, and
    not the oracle's mean of V); the plain version follows the kernel."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (2, 64, 16), (2, 16, 16))
    want = np.asarray(jflash(jq, jk, jv, causal=False, window=8,
                             interpret=True))
    got = ref.flash_attention(tq_, tk_, tv, causal=False, window=8).numpy()
    masked = slice(23, None)          # row i sees keys j > i - 8, j < 16
    assert np.all(want[:, masked] == 0) and np.all(got[:, masked] == 0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    oracle = ref.ref_attention(tq_, tk_, tv, causal=False, window=8).numpy()
    assert np.abs(oracle[:, masked]).max() > 0.1     # the oracle differs


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 5)])
def test_ref_attention_matches_reference_oracle(causal, window):
    rng = np.random.default_rng(window)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (6, 24, 16), (3, 24, 16))
    want = jref_attention(jq, jk, jv, causal=causal, window=window)
    got = ref.ref_attention(tq_, tk_, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_model_layout_is_the_kernel_layout_transposed():
    """(B, S, H, hd) with head h = kv·G + g reading KV head h // G is the
    (B·H, S, hd) layout with row bh reading KV row bh // G
    (tests/test_flash_kernel.py:66-72)."""
    b, s, h, kvh, hd = 2, 24, 4, 2, 16
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    got = ref.flash_attention(q, k, v, causal=True, window=5)
    flat = ref.flash_attention(
        q.transpose(1, 2).reshape(b * h, s, hd),
        k.transpose(1, 2).reshape(b * kvh, s, hd),
        v.transpose(1, 2).reshape(b * kvh, s, hd), causal=True, window=5)
    torch.testing.assert_close(
        got, flat.reshape(b, h, s, hd).transpose(1, 2), rtol=0, atol=0)


@pytest.mark.parametrize("threshold,chunk", [(10_000, 1024), (1, 16)],
                         ids=["block", "flash"])
@pytest.mark.parametrize("window", [0, 7])
def test_attend_matches_reference(threshold, chunk, window):
    b, sq, h, kvh, hd = 2, 40, 4, 2, 16
    rng = np.random.default_rng(window)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (b, sq, h, hd),
                                        (b, sq, kvh, hd))
    pos = jnp.arange(sq)
    want = jattn.attend(jq, jk, jv, q_pos=pos, kv_pos=pos, causal=True,
                        window=window, chunk=chunk, flash_threshold=threshold)
    got = tattn.attend(tq_, tk_, tv, causal=True, window=window, chunk=chunk,
                       flash_threshold=threshold)
    np.testing.assert_allclose(_np(got), _np(want), **ATTEND_TOL)
    # explicit positions (the CPU path takes them) give the same result
    tpos = torch.arange(sq)
    again = tattn.attend(tq_, tk_, tv, q_pos=tpos, kv_pos=tpos, causal=True,
                         window=window, chunk=chunk, flash_threshold=threshold)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("threshold,chunk", [(10_000, 1024), (1, 16)],
                         ids=["block", "flash"])
@pytest.mark.parametrize("n_valid", [1, 13, 48])
def test_attend_kv_len_matches_reference_kv_valid(threshold, chunk, n_valid):
    """A decode step: one query, non-causal, over a cache whose first
    ``n_valid`` slots are filled (the reference's ``kv_valid`` prefix)."""
    b, w, h, kvh, hd = 2, 48, 4, 2, 16
    rng = np.random.default_rng(n_valid)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (b, 1, h, hd), (b, w, kvh, hd))
    valid = jnp.broadcast_to(jnp.arange(w)[None, :] < n_valid, (b, w))
    want = jattn.attend(jq, jk, jv, q_pos=jnp.full((1,), n_valid - 1),
                        kv_pos=jnp.zeros((w,), jnp.int32), causal=False,
                        window=0, kv_valid=valid, chunk=chunk,
                        flash_threshold=threshold)
    got = tattn.attend(tq_, tk_, tv, causal=False, window=0, kv_len=n_valid,
                       chunk=chunk, flash_threshold=threshold)
    np.testing.assert_allclose(_np(got), _np(want), **ATTEND_TOL)
    # the kernel's plain version computes the same on the same call
    plain = ref.flash_attention(tq_, tk_, tv, causal=False, kv_len=n_valid)
    np.testing.assert_allclose(_np(plain), _np(want), **ATTEND_TOL)


def test_attend_probs_bf16_matches_reference():
    b, sq, h, kvh, hd = 1, 40, 2, 1, 16
    rng = np.random.default_rng(3)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (b, sq, h, hd),
                                        (b, sq, kvh, hd))
    pos = jnp.arange(sq)
    want = jattn.attend(jq, jk, jv, q_pos=pos, kv_pos=pos, causal=True,
                        chunk=16, flash_threshold=1, probs_bf16=True)
    got = tattn.attend(tq_, tk_, tv, causal=True, chunk=16,
                       flash_threshold=1, probs_bf16=True)
    np.testing.assert_allclose(_np(got), _np(want), **ATTEND_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 9))
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_mrope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 512, size=(3, 2, 7))
    want = jattn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2),
                             1e6)
    got = tattn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                            (4, 2, 2), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        tattn.text_mrope_positions(2, 5, "cpu").numpy(),
        np.asarray(jattn.text_mrope_positions(2, 5)))


def test_kernel_wrapper_refuses_cpu_tensors_before_building():
    """The CUDA wrapper checks its inputs before it reaches nvcc: a CPU
    tensor raises here, on a machine without a card, and nothing is
    counted (tests/test_torch_gpu.py checks the other refusals)."""
    q = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tkf.flash_attention(q, q, q)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_attend_on_cpu_takes_no_kernel_and_counts_nothing():
    rng = np.random.default_rng(2)
    _, (tq_, tk_, tv) = _qkv(rng, (1, 8, 2, 16), (1, 8, 1, 16))
    tattn.attend(tq_, tk_, tv, causal=True)
    tattn.attend(tq_, tk_, tv, causal=True, flash_threshold=1, chunk=4)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# The CUDA wrapper's route table and decode split plan are pure Python:
# they are held here; the kernels themselves on the card
# (tests/test_torch_gpu.py).
@pytest.mark.parametrize("dtype,sq,hd,want", [
    (torch.bfloat16, 1, 128, "decode"), (torch.float32, 1, 128, "decode"),
    (torch.bfloat16, 16, 16, "decode"), (torch.float32, 16, 64, "decode"),
    (torch.bfloat16, 17, 128, "tc"), (torch.bfloat16, 2048, 64, "tc"),
    (torch.bfloat16, 40, 32, "cuda_core"), (torch.bfloat16, 64, 16,
                                             "cuda_core"),
    (torch.float32, 17, 128, "cuda_core"), (torch.float32, 2048, 64,
                                            "cuda_core"),
])
def test_route_table(dtype, sq, hd, want):
    assert tkf.route(dtype, sq, hd) == want
    assert want in tkf.ROUTES


def test_serving_shapes_never_take_the_cuda_core_route_in_bf16():
    """Every configured model has hd 64 or 128: in bf16 its prefill takes
    the tensor cores and its decode the split-KV kernel."""
    from repro_torch.configs import ARCHS, get_config
    for name in ARCHS:
        hd = get_config(name).hd
        if hd not in tkf.HEAD_DIMS:
            continue
        assert tkf.route(torch.bfloat16, 2048, hd) == "tc", name
        assert tkf.route(torch.bfloat16, 1, hd) == "decode", name


@pytest.mark.parametrize("hd,itemsize,tile", [
    (128, 2, 64), (128, 4, 32), (64, 2, 128), (64, 4, 64), (32, 2, 128),
    (32, 4, 128), (16, 2, 128), (16, 4, 128)])
def test_decode_tile_is_16kb_of_keys_at_most_128(hd, itemsize, tile):
    assert tkf.decode_tile(hd, itemsize) == tile


@pytest.mark.parametrize("rows,rb", [(1, 2), (2, 2), (3, 8), (8, 8), (9, 16),
                                     (16, 16), (128, 16)])
def test_decode_row_block(rows, rb):
    assert tkf.decode_row_block(rows) == rb


@pytest.mark.parametrize("blocks", [1, 32, 132, 1000])
@pytest.mark.parametrize("k_end", [0, 1, 64, 65, 2049, 40000])
@pytest.mark.parametrize("tile", [32, 64, 128])
def test_decode_plan_covers_the_keys_with_the_fewest_tiles_a_split(
        blocks, k_end, tile):
    splits, chunk = tkf.decode_plan(blocks, k_end, tile)
    assert splits >= 1 and chunk % tile == 0 and chunk > 0
    assert splits * chunk >= k_end
    if k_end == 0:
        assert splits == 1
        return
    assert (splits - 1) * chunk < k_end          # no split is past the keys
    tiles = -(-k_end // tile)
    want = -(-2 * tkf.H100_SMS // blocks)        # two blocks an SM
    assert splits <= max(1, want)
    # no plan with at most `want` splits has a lighter heaviest split
    assert chunk // tile == -(-tiles // min(max(1, want), tiles))


@pytest.mark.parametrize("kv_len", [2049, 2080])
def test_decode_plan_at_qwen3_decode(kv_len):
    """qwen3-1.7b at batch 4: 32 (batch, KV head) groups, bf16 hd 128 (64
    keys a tile) -> 9 splits of 256 keys, 288 blocks on 132 SMs."""
    assert tkf.decode_plan(32, kv_len, tkf.decode_tile(128, 2)) == (9, 256)


SPLIT_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.mark.parametrize("kv_len", [0, 1, 7, 17, 40, 48])
@pytest.mark.parametrize("chunk", [1, 8, 64])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (False, 3),
                                           (True, 5)])
def test_split_model_matches_plain_and_pallas_kernel(kv_len, chunk, causal,
                                                     window):
    """The decode kernel's partial-and-merge arithmetic (plain model in
    ref.py) against the plain flash attention and the Pallas kernel run on
    the first kv_len keys (its pad mask), at 1e-5 in f32; chunk 1 makes
    most splits of the early rows empty under causality."""
    rng = np.random.default_rng(kv_len + 7 * chunk + window)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (6, 5, 32), (3, 48, 32))
    got = ref.flash_attention_split(tq_, tk_, tv, chunk=chunk, causal=causal,
                                    window=window, kv_len=kv_len)
    plain = ref.flash_attention(tq_, tk_, tv, causal=causal, window=window,
                                kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **SPLIT_TOL)
    if kv_len == 0:                      # one empty split: zeros, no NaN
        assert np.all(got.numpy() == 0)
        return
    want = jflash(jq, jk[:, :kv_len], jv[:, :kv_len], causal=causal,
                  window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **SPLIT_TOL)


@pytest.mark.parametrize("group", [1, 2, 7, 8])
def test_split_model_fully_masked_rows_are_zero_as_the_pallas_kernel(group):
    """16 query rows at window 3 over 4 keys: rows 6.. see no key. They
    give exactly 0 through the merge, as in the Pallas kernel."""
    rng = np.random.default_rng(group)
    (jq, jk, jv), (tq_, tk_, tv) = _qkv(rng, (2 * group, 16, 16),
                                        (2, 20, 16))
    got = ref.flash_attention_split(tq_, tk_, tv, chunk=2, causal=False,
                                    window=3, kv_len=4).numpy()
    want = np.asarray(jflash(jq, jk[:, :4], jv[:, :4], causal=False,
                             window=3, interpret=True))
    assert np.all(got[:, 6:] == 0) and np.all(want[:, 6:] == 0)
    assert np.isfinite(got).all() and np.abs(got[:, :6]).max() > 0.1
    np.testing.assert_allclose(got, want, **SPLIT_TOL)


def test_split_model_takes_the_model_layout_and_the_kernel_plan():
    """A decode step's (B, 1, H, hd) query against a (B, Skv, KV, hd)
    cache, cut as the wrapper's plan cuts it, equals the plain version."""
    b, h, kvh, hd, skv, kv_len = 2, 4, 2, 32, 300, 257
    rng = np.random.default_rng(5)
    _, (tq_, tk_, tv) = _qkv(rng, (b, 1, h, hd), (b, skv, kvh, hd))
    tile = tkf.decode_tile(hd, 4)
    splits, chunk = tkf.decode_plan(b * kvh, kv_len, tile)
    assert splits > 1
    got = ref.flash_attention_split(tq_, tk_, tv, chunk=chunk, causal=False,
                                    kv_len=kv_len)
    want = ref.flash_attention(tq_, tk_, tv, causal=False, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SPLIT_TOL)
