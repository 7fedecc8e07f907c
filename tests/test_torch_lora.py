"""The port's LoRA fine-tuning pieces against the reference on the CPU:
``inject_lora`` (paths, shapes, dtypes, rank clipping, errors, the adapted
forward equal to the base), ``lm_loss`` and its adapter gradient against
``jax.value_and_grad``, ``ModelConfig.remat_blocks`` under
``vmap(grad_and_value)``, and :class:`FlashAttentionFn` (the kernel's
differentiable form; on CPU tensors its forward is the plain
``ref.flash_attention``) under ``torch.func.vmap(grad)`` against autograd
of the plain version, alone and inside the model's blocks."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad, grad_and_value, vmap  # noqa: E402

from test_torch_engine import to_torch  # noqa: E402

from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.lora import inject_lora as jinject  # noqa: E402
from repro.models.lora import lora_partition as jlora_partition  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.core.partition import leaf_paths  # noqa: E402
from repro_torch.federated import make_local_update  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttentionFn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lora import (LORA_SUBTREES, LORA_TARGETS,  # noqa: E402
                                     inject_lora, lora_partition)
from repro_torch.optim import sgd  # noqa: E402

LOSS_TOL, GRAD_TOL = 1e-5, 2e-5
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TINY = dict(name="tiny", family="dense", d_model=64, num_layers=2,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            param_dtype="float32", compute_dtype="float32")


def _tiny(**kw):
    return JModelConfig(**{**TINY, **kw}), ModelConfig(**{**TINY, **kw})


def _shapes(tree):
    return {p: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for p, l in leaf_paths(tree)}


# ----------------------------------------------------------------------
# inject_lora
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [2, 200])
def test_inject_lora_matches_reference_layout(dtype, rank):
    """Paths, shapes (rank clipped to min(rank, d_in, d_out)) and dtypes as
    the reference's; b is zero, a has std 1/sqrt(d_in); the base tensors
    are shared, not copied."""
    jcfg, tcfg = _tiny(param_dtype=dtype, compute_dtype=dtype)
    jp = jinject(jax.random.PRNGKey(1),
                 jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=rank)
    base = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp = inject_lora(base, rank, torch.Generator().manual_seed(1))
    want = {p: (tuple(l.shape), str(l.dtype))
            for p, l in leaf_paths(jax.tree.map(np.asarray, jp))}
    assert _shapes(tp) == want
    assert lora_partition(tp).trainable_paths == \
        jlora_partition(jp).trainable_paths
    assert tp["blocks"]["attn"]["wq"] is base["blocks"]["attn"]["wq"]
    lora = tp["blocks"]["mlp"]["lora"]["w_down"]
    assert not lora["b"].any()
    d_in = tcfg.d_ff
    std = float(lora["a"].float().std())
    assert 0.5 / np.sqrt(d_in) < std < 1.5 / np.sqrt(d_in)


def test_inject_lora_forward_equals_base_bit_for_bit():
    _, tcfg = _tiny()
    base = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp = inject_lora(base, 4, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(2, 9)))
    assert torch.equal(tfm.forward(tp, tcfg, tokens)[0],
                       tfm.forward(base, tcfg, tokens)[0])


def test_inject_lora_targets_and_errors():
    _, tcfg = _tiny()
    base = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="rank must be >= 1"):
        inject_lora(base, 0, gen)
    with pytest.raises(ValueError, match="no eligible projection"):
        inject_lora(base, 2, gen, targets={"ssm": ("in_proj",)})
    with pytest.raises(ValueError, match="no eligible projection"):
        inject_lora({"head": {"w": torch.zeros(3, 4)}}, 2, gen)
    only_q = inject_lora(base, 2, gen, targets={"attn": ("wq",)})
    assert set(only_q["blocks"]["attn"]["lora"]) == {"wq"}
    assert "lora" not in only_q["blocks"]["mlp"]
    assert LORA_SUBTREES == ("blocks", "enc_blocks")
    assert LORA_TARGETS["attn"] == ("wq", "wk", "wv", "wo")


# ----------------------------------------------------------------------
# lm_loss and its adapter gradient
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_params():
    """The reference's tiny LM with rank-2 adapters whose b is perturbed
    (so the gradient reaches every factor), and the same numbers in the
    port."""
    jcfg, _ = _tiny()
    jp = jinject(jax.random.PRNGKey(1),
                 jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=2)
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, l: l + 0.05 * rng.normal(size=l.shape).astype(
            np.float32) if path[-1].key == "b" and "lora" in
        jax.tree_util.keystr(path) else l, jp)
    return jp, to_torch(jp)


def _batch(vocab, masked):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, size=(3, 16)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(3, 16)).astype(np.int32)
    if masked:
        labels[0, :5] = -1
        labels[2, 9] = -1
    return tokens, labels


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_adapter_grad_match_reference(lm_params, masked):
    jcfg, tcfg = _tiny()
    jp, tp = lm_params
    tokens, labels = _batch(tcfg.vocab_size, masked)
    jpart = jlora_partition(jp)
    jtr, jfz = jpart.split(jp)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda tr: jtfm.lm_loss(jpart.merge(tr, jfz), jcfg,
                                {"tokens": jnp.asarray(tokens),
                                 "labels": jnp.asarray(labels)})))(jtr)
    tpart = lora_partition(tp)
    ttr, tfz = tpart.split(tp)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    tgrads, tloss = grad_and_value(
        lambda tr: tfm.lm_loss(tpart.merge(tr, tfz), tcfg, batch))(ttr)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    want = dict(leaf_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(leaf_paths(params_to_numpy(tgrads)))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=GRAD_TOL,
                                   rtol=0, err_msg=path)
    # make_lm_loss is the same function
    assert float(tfm.make_lm_loss(tcfg)(tp, batch)) == float(tloss)


def test_lm_loss_ignores_masked_labels(lm_params):
    _, tcfg = _tiny()
    _, tp = lm_params
    tokens, labels = _batch(tcfg.vocab_size, masked=True)
    other = labels.copy()
    other[labels < 0] = -7
    losses = [float(tfm.lm_loss(tp, tcfg, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(lab)})) for lab in (labels, other)]
    assert losses[0] == losses[1]
    every = float(tfm.lm_loss(tp, tcfg, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.full(labels.shape, -1)}))
    assert every == 0.0


# ----------------------------------------------------------------------
# remat_blocks and FLConfig.remat
# ----------------------------------------------------------------------
def _client_grads(tp, tcfg, batch):
    """Per-client adapter gradients and losses under vmap(grad_and_value)
    with the frozen base closed over, as the vmap round computes them."""
    part = lora_partition(tp)
    tr, fz = part.split(tp)
    fn = grad_and_value(lambda t, b: tfm.lm_loss(part.merge(t, fz), tcfg, b))
    return vmap(fn, in_dims=(None, 0))(tr, batch)


def _client_batch(vocab, k=3):
    rng = np.random.default_rng(11)
    return {"tokens": torch.from_numpy(rng.integers(
                0, vocab, size=(k, 2, 12)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(
                0, vocab, size=(k, 2, 12)).astype(np.int32))}


def test_remat_blocks_is_bit_identical_under_vmap_grad(lm_params):
    _, tcfg = _tiny()
    _, tp = lm_params
    batch = _client_batch(tcfg.vocab_size)
    g0, l0 = _client_grads(tp, tcfg, batch)
    g1, l1 = _client_grads(tp, dataclasses.replace(tcfg, remat_blocks=True),
                           batch)
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(leaf_paths(g0), leaf_paths(g1)):
        assert torch.equal(a, b), p


def test_flconfig_remat_changes_nothing(lm_params):
    _, tcfg = _tiny()
    _, tp = lm_params
    part = lora_partition(tp)
    tr, fz = part.split(tp)
    batch = {k: v[0] for k, v in _client_batch(tcfg.vocab_size).items()}
    outs = [make_local_update(tfm.make_lm_loss(tcfg), sgd(0.05), 2,
                              remat=remat, partition=part)(tr, batch, fz)
            for remat in (False, True)]
    assert torch.equal(outs[0][1], outs[1][1])
    for (_, a), (_, b) in zip(leaf_paths(outs[0][0]), leaf_paths(outs[1][0])):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# FlashAttentionFn under torch.func
# ----------------------------------------------------------------------
FA_CASES = {            # (H, KV, Sq=Skv, causal, window, kv_len)
    "causal_g2": (4, 2, 9, True, 0, None),
    "causal_g1": (2, 2, 9, True, 0, None),
    "window": (4, 2, 11, True, 3, None),
    "kv_len": (4, 2, 8, False, 0, 5),
    "masked_rows": (4, 2, 8, False, 2, 2),   # rows >= 3 see no key
    "no_key": (2, 1, 6, False, 0, 0),
}


def _fa_inputs(h, kvh, s, dtype, n=3, b=2, hd=16):
    rng = np.random.default_rng(h * 100 + s)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)

    return (t(n, b, s, h, hd), t(n, b, s, kvh, hd), t(n, b, s, kvh, hd),
            t(n, b, s, h, hd))


def _fa_loss(attn_fn):
    def loss(q, k, v, w):
        return (attn_fn(q, k, v).float() * w.float()).sum()
    return loss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_fn_grads_under_vmap(case, dtype):
    h, kvh, s, causal, window, kv_len = FA_CASES[case]
    q, k, v, w = _fa_inputs(h, kvh, s, dtype)
    fn = _fa_loss(lambda q, k, v: FlashAttentionFn.apply(
        q, k, v, causal, window, kv_len))
    got = vmap(grad(fn, argnums=(0, 1, 2)))(q, k, v, w)
    # autograd of the plain version, client by client
    want = []
    for i in range(q.shape[0]):
        leaves = [t[i].clone().requires_grad_() for t in (q, k, v)]
        out = kref.flash_attention(*leaves, causal=causal, window=window,
                                   kv_len=kv_len)
        (out.float() * w[i].float()).sum().backward()
        want.append([t.grad for t in leaves])
    for j, name in enumerate("qkv"):
        ref_g = torch.stack([w_[j] for w_ in want]).float()
        scale = max(1.0, float(ref_g.abs().max()))
        assert got[j].dtype == dtype
        err = float((got[j].float() - ref_g).abs().max())
        assert err <= FA_TOL[dtype] * scale, (name, err)
    if case in ("masked_rows", "no_key"):
        visible = kref._attention_mask(
            s, s, causal, window, s if kv_len is None else kv_len,
            "cpu").expand(s, s).any(dim=1)
        assert not visible.all()
        assert not got[0][:, :, ~visible].any()


def test_flash_attention_fn_unbatched_kv_in_dim():
    """k and v shared by every client (in_dims None) are expanded over the
    vmapped dim; their gradient sums the clients'."""
    q, k, v, w = _fa_inputs(4, 2, 9, torch.float32)
    fn = _fa_loss(lambda q, k, v: FlashAttentionFn.apply(q, k, v, True, 0,
                                                         None))
    got = vmap(grad(fn, argnums=(0, 1, 2)), in_dims=(0, None, None, 0))(
        q, k[0], v[0], w)
    plain = _fa_loss(lambda q, k, v: kref.flash_attention(q, k, v))
    want = vmap(grad(plain, argnums=(0, 1, 2)), in_dims=(0, None, None, 0))(
        q, k[0], v[0], w)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= FA_TOL[torch.float32]


def test_flash_attention_fn_forward_and_plain_autograd():
    """Outside the transforms: the forward is the plain version's value, and
    loss.backward() through the Function gives autograd's gradient."""
    q, k, v, w = (t[0] for t in _fa_inputs(4, 2, 9, torch.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, True, 2, None)
    assert torch.equal(out.detach(), kref.flash_attention(q, k, v, window=2))
    (out * w).sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    (kref.flash_attention(*plain, window=2) * w).sum().backward()
    for a, b in zip(leaves, plain):
        assert float((a.grad - b.grad).abs().max()) <= FA_TOL[torch.float32]


@pytest.mark.parametrize("remat", [False, True])
def test_model_through_flash_attention_fn_matches_plain(lm_params,
                                                         monkeypatch, remat):
    """The card's training path on the CPU: ``attend`` patched to take
    FlashAttentionFn (as it does on CUDA), nested in the recompute blocks
    when ``remat_blocks``; the per-client adapter gradients under
    vmap(grad_and_value) equal the plain path's at 1e-5."""
    _, tcfg = _tiny(remat_blocks=remat)
    _, tp = lm_params
    batch = _client_batch(tcfg.vocab_size)
    g0, l0 = _client_grads(tp, tcfg, batch)
    calls = []

    def attend(q, k, v, *, causal=True, window=0, **_):
        calls.append(q.shape)
        return FlashAttentionFn.apply(q, k, v, causal, window, None)

    monkeypatch.setattr(tattn, "attend", attend)
    g1, l1 = _client_grads(tp, tcfg, batch)
    assert calls        # the patched attention ran
    assert float((l0 - l1).abs().max()) <= LOSS_TOL
    for (p, a), (_, b) in zip(leaf_paths(g0), leaf_paths(g1)):
        assert float((a - b).abs().max()) <= GRAD_TOL, p
