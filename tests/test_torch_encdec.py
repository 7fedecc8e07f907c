"""The port's encoder-decoder block kinds (``enc``, ``dec``: the ``audio``
family, seamless-m4t-large-v2) against the reference on the CPU, with the
reference's weights carried across by ``bridge.params_from_numpy``:
``_cross_attn``, ``_encode`` and ``_enc_kv_all`` against
``repro.models.transformer`` in f32; the encoder's self-attention is
non-causal; the parameter trees against ``jax.eval_shape``;
``inject_lora``'s paths (adapters under ``enc_blocks`` and ``blocks``,
none on ``cross``); ``lm_loss`` and every leaf's gradient against
``jax.value_and_grad`` (also under ``torch.func.vmap(grad_and_value)``);
``remat_blocks`` bit for bit; one fedldf round of the reduced config in
vmap and scan mode; and the frames' dtype: bf16 frames given to both
packages, and f32 frames into a bf16 model promoted as jnp promotes them
(the encoder and the cross K/V in f32)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from test_torch_engine import LOSS_TOL, PARAM_TOL, max_diff, to_torch  # noqa: E402
from test_torch_ssm import (LOSS_GRAD_TOL, _assert_grads,  # noqa: E402
                            _tree)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.units import UnitMap as JUnitMap  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import build_round_scan as jbuild_round_scan  # noqa: E402
from repro.federated import build_round_vmap as jbuild_round_vmap  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.lora import inject_lora as jinject  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import leaf_paths  # noqa: E402
from repro_torch.core.units import UnitMap, tree_unbind  # noqa: E402
from repro_torch.federated import (FLConfig, build_round_scan,  # noqa: E402
                                   build_round_vmap)
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lora import inject_lora, lora_partition  # noqa: E402

ENC_TOL = 1e-5
ARCH = "seamless-m4t-large-v2"
# tests/test_decode_consistency.py:31 (its mk base, the audio case)
TINY = dict(name="t-audio", family="audio", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=97, encoder_layers=2, frontend_dim=24)


def _cfgs(name, **kw):
    if name == "tiny":
        base = {**TINY, **kw}
        return JModelConfig(**base), ModelConfig(**base)

    def f32(c):
        return dataclasses.replace(c.reduced(), **{
            "param_dtype": "float32", "compute_dtype": "float32", **kw})
    return f32(jget_config(ARCH)), f32(get_config(ARCH))


def _frames(cfg, b=2, s=13, seed=5, lead=()):
    return np.random.default_rng(seed).normal(
        size=lead + (b, s, cfg.frontend_dim)).astype(np.float32)


def _close(got, want, tol=ENC_TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.fixture(scope="module", params=["tiny", "reduced"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, to_torch(jp)


# ----------------------------------------------------------------------
# the encoder, its cross K/V and the cross-attention
# ----------------------------------------------------------------------
def test_encode_and_enc_kv_all_match_reference(model):
    """The frontend stub's projection and the encoder stack (13 frames),
    then every decoder layer's stacked (L, B, S_enc, KV, hd) cross K/V."""
    jcfg, tcfg, jp, tp = model
    fr = _frames(tcfg)
    jout = jtfm._encode(jp, jcfg, jnp.asarray(fr))
    tout = tfm._encode(tp, tcfg, torch.from_numpy(fr))
    assert tout.shape == (2, 13, tcfg.d_model)
    _close(tout, jout, msg="encode")
    jk, jv = jtfm._enc_kv_all(jp, jcfg, jout)
    tk, tv = tfm._enc_kv_all(tree_unbind(tp["blocks"]), tcfg, tout)
    shape = (tcfg.num_layers, 2, 13, tcfg.num_kv_heads, tcfg.hd)
    assert tuple(tk.shape) == tuple(tv.shape) == shape == jk.shape
    _close(tk, jk, msg="cross k")
    _close(tv, jv, msg="cross v")


def test_cross_attn_matches_reference(model):
    """One decoder layer's cross-attention: 9 query rows over 13 frames,
    every frame visible; a sliding window on the model does not apply."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, sliding_window=2)
    tcfg = dataclasses.replace(tcfg, sliding_window=2)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(2, 13, tcfg.num_kv_heads, tcfg.hd))
          .astype(np.float32) for _ in range(2)]
    jcross = jax.tree.map(lambda l: l[1], jp["blocks"]["cross"])
    tcross = {n: t[1] for n, t in tp["blocks"]["cross"].items()}
    want = jtfm._cross_attn(jcross, jcfg, jnp.asarray(x),
                            tuple(map(jnp.asarray, kv)))
    got = tfm._cross_attn(tcross, tcfg, torch.from_numpy(x),
                          tuple(map(torch.from_numpy, kv)))
    _close(got, want)


def test_encoder_is_not_causal(model):
    """Changing the last frame changes the encoder's first row (and the
    reference agrees on the changed output)."""
    jcfg, tcfg, jp, tp = model
    fr = _frames(tcfg)
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    a = tfm._encode(tp, tcfg, torch.from_numpy(fr))
    b = tfm._encode(tp, tcfg, torch.from_numpy(fr2))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    _close(b, jtfm._encode(jp, jcfg, jnp.asarray(fr2)))


def test_forward_needs_frames(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="enc_inputs"):
        tfm.forward(tp, tcfg, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="enc_inputs"):
        tdec.prefill(tp, tcfg, torch.zeros((1, 4), dtype=torch.long))


# ----------------------------------------------------------------------
# the trees
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tiny", "reduced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_reference_tree(name, dtype):
    """Paths, shapes and dtypes against ``jax.eval_shape``: ``enc_blocks``
    (``encoder_layers`` deep, no cross), ``enc_embed`` and a ``dec`` block
    with ``ln_cross`` and ``cross``; with ``qk_norm`` and ``qkv_bias`` the
    cross-attention has the biases and no norm scales."""
    for kw in ({}, {"qk_norm": True, "qkv_bias": True}):
        jcfg, tcfg = _cfgs(name, param_dtype=dtype, compute_dtype=dtype,
                           **kw)
        shapes = jax.eval_shape(
            lambda: jtfm.init_params(jax.random.PRNGKey(0), jcfg))
        tp = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert _tree(tp) == _tree(shapes)
        assert set(tp["blocks"]) == {"ln1", "attn", "ln_cross", "cross",
                                     "ln2", "mlp"}
        assert set(tp["enc_blocks"]) == {"ln1", "attn", "ln2", "mlp"}
        assert tp["enc_blocks"]["ln1"].shape[0] == tcfg.encoder_layers
        assert not any("norm" in p for p, _ in
                       leaf_paths(tp["blocks"]["cross"]))


def test_inject_lora_paths_match_reference():
    """Adapters on the self-attention and MLP projections of both stacks
    (``enc_blocks`` and ``blocks``), none on the cross-attention."""
    jcfg, tcfg = _cfgs("reduced")
    jp = jinject(jax.random.PRNGKey(1),
                 jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=4)
    tp = inject_lora(tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                                      "cpu"), 4,
                     torch.Generator().manual_seed(1))
    assert _tree(tp) == _tree(jax.tree.map(np.asarray, jp))
    for sub in ("blocks", "enc_blocks"):
        assert set(tp[sub]["attn"]["lora"]) == {"wq", "wk", "wv", "wo"}
        assert set(tp[sub]["mlp"]["lora"]) == {"w_gate", "w_up", "w_down"}
    assert "lora" not in tp["blocks"]["cross"]
    assert len(lora_partition(tp).trainable_paths) == 28


# ----------------------------------------------------------------------
# the loss and its gradient
# ----------------------------------------------------------------------
def _lm_batch(cfg, lead=(2,)):
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=lead + (11,))
            .astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, size=lead + (11,))
            .astype(np.int32),
            "enc_inputs": _frames(cfg, b=lead[-1], s=9, seed=8,
                                  lead=lead[:-1])}


def _jloss_grad(jcfg, jp, batch):
    return jax.jit(jax.value_and_grad(lambda p: jtfm.lm_loss(
        p, jcfg, {n: jnp.asarray(x) for n, x in batch.items()})))(jp)


def _torch_batch(batch):
    return {n: torch.from_numpy(x) for n, x in batch.items()}


def test_lm_loss_and_grad_match_reference(model):
    """Every leaf's gradient, the encoder's and the cross-attention's
    included."""
    jcfg, tcfg, jp, tp = model
    batch = _lm_batch(tcfg)
    jloss, jgrads = _jloss_grad(jcfg, jp, batch)
    tb = _torch_batch(batch)
    tgrads, tloss = grad_and_value(lambda p: tfm.lm_loss(p, tcfg, tb))(tp)
    assert abs(float(tloss) - float(jloss)) <= LOSS_GRAD_TOL
    _assert_grads(tgrads, jgrads)
    assert float(tgrads["enc_blocks"]["attn"]["wq"].abs().max()) > 0.0


def _vmap_grads(tcfg, tp, batch):
    return vmap(grad_and_value(lambda p, b: tfm.lm_loss(p, tcfg, b)),
                in_dims=(None, 0))(tp, _torch_batch(batch))


def test_lm_loss_and_grad_under_vmap_match_reference(model):
    """Two clients' batches (tokens and frames) under
    vmap(grad_and_value), the model shared, each against the reference's
    value_and_grad on its own batch."""
    jcfg, tcfg, jp, tp = model
    batch = _lm_batch(tcfg, lead=(2, 2))
    tgrads, tloss = _vmap_grads(tcfg, tp, batch)
    for i in range(2):
        jloss, jgrads = _jloss_grad(jcfg, jp, {n: x[i] for n, x in
                                               batch.items()})
        assert abs(float(tloss[i]) - float(jloss)) <= LOSS_GRAD_TOL
        _assert_grads(jax.tree.map(lambda g: g[i], tgrads), jgrads)


def test_remat_blocks_is_bit_identical_under_vmap_grad(model):
    """Both stacks under remat (a dec block takes its layer's cross K/V
    as tensor arguments)."""
    _, tcfg, _, tp = model
    batch = _lm_batch(tcfg, lead=(2, 2))
    g0, l0 = _vmap_grads(tcfg, tp, batch)
    g1, l1 = _vmap_grads(dataclasses.replace(tcfg, remat_blocks=True), tp,
                         batch)
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(leaf_paths(g0), leaf_paths(g1)):
        assert torch.equal(a, b), p


# ----------------------------------------------------------------------
# one fedldf round of the reduced config (tests/test_arch_smoke.py:66)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_fedldf_round_of_reduced_config_matches_reference(mode):
    """seamless-m4t-large-v2 reduced, fedldf with 4 clients, K = 3, top-2,
    lr 0.01, on the reference's params and its client batches (tokens and
    frames); the selection covers the ``enc_blocks/i`` units too."""
    jcfg, tcfg = _cfgs("reduced")
    k = 3
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    key = jax.random.PRNGKey(0)
    jbatch = {"tokens": jax.random.randint(key, (k, 2, 12), 0,
                                           jcfg.vocab_size),
              "labels": jax.random.randint(key, (k, 2, 12), 0,
                                           jcfg.vocab_size),
              "enc_inputs": jax.random.normal(key, (k, 2, 10,
                                                    jcfg.frontend_dim))}
    kw = dict(algo="fedldf", num_clients=4, clients_per_round=k, top_n=2,
              lr=0.01, mode=mode)
    jbuild, tbuild = {"vmap": (jbuild_round_vmap, build_round_vmap),
                      "scan": (jbuild_round_scan, build_round_scan)}[mode]
    jumap = JUnitMap.build(jparams)
    jround = jax.jit(jbuild(lambda p, b: jtfm.lm_loss(p, jcfg, b), jumap,
                            JFLConfig(**kw)))
    jnew, jmet = jround(jparams, jbatch, jnp.ones((k,)), key)
    tparams = to_torch(jparams)
    umap = UnitMap.build(tparams)
    assert list(umap.names) == list(jumap.names)
    assert any(n.startswith("enc_blocks/") for n in umap.names)
    tround = tbuild(tfm.make_lm_loss(tcfg), umap, FLConfig(**kw))
    tnew, tmet = tround(tparams, {n: torch.from_numpy(np.array(v))
                                  for n, v in jbatch.items()},
                        torch.ones(k))
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    np.testing.assert_array_equal(np.asarray(tmet["selection"]),
                                  np.asarray(jmet["selection"]))
    assert max_diff(tnew, jax.tree.map(np.asarray, jnew)) <= PARAM_TOL
    assert max_diff(tnew, jax.tree.map(np.asarray, jparams)) > 0.0


# ----------------------------------------------------------------------
# the frames' dtype
# ----------------------------------------------------------------------
def _bf16_cfgs():
    return _cfgs("reduced", param_dtype="bfloat16",
                 compute_dtype="bfloat16")


def test_bf16_frames_match_reference():
    """A bf16 model given bf16 frames in both packages (the reference's
    dry-run dtype): the encoder's output, forward and prefill's logits
    and cross K/V, within bf16 rounding of the reference's."""
    jcfg, tcfg = _bf16_cfgs()
    jp = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = to_torch(jp)
    fr = _frames(tcfg)
    jfr = jnp.asarray(fr).astype(jnp.bfloat16)
    tfr = torch.from_numpy(fr).bfloat16()
    tol = 3e-2
    jout = jtfm._encode(jp, jcfg, jfr)
    tout = tfm._encode(tp, tcfg, tfr)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    scale = float(jnp.abs(jout.astype(jnp.float32)).max())
    _close(tout, jout, tol * scale)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size,
                                             size=(2, 8)).astype(np.int32)
    jlg, jcache = jdec.prefill(jp, jcfg, jnp.asarray(toks), enc_inputs=jfr)
    tlg, tcache = tdec.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                               enc_inputs=tfr)
    scale = float(jnp.abs(jlg.astype(jnp.float32)).max())
    _close(tlg, jlg.astype(jnp.float32), tol * scale)
    for key in ("cross_k", "cross_v"):
        assert tcache[key].dtype == torch.bfloat16
        assert jcache[key].dtype == jnp.bfloat16
        scale = float(jnp.abs(jcache[key].astype(jnp.float32)).max())
        _close(tcache[key], jcache[key].astype(jnp.float32), tol * scale,
               key)


def test_f32_frames_into_a_bf16_model_are_cast():
    """f32 frames into a bf16 model follow jnp's promotion: the encoder's
    bf16 weights are cast up (exact), so ``_encode`` is f32 and within
    1e-5 of max |out| of the reference's f32 encoder, and so is every
    decoder layer's cross K/V from it (``_enc_kv_all``)."""
    jcfg, tcfg = _bf16_cfgs()
    jp = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = to_torch(jp)
    fr = _frames(tcfg)
    jout = jtfm._encode(jp, jcfg, jnp.asarray(fr))
    tout = tfm._encode(tp, tcfg, torch.from_numpy(fr))
    assert jout.dtype == jnp.float32 and tout.dtype == torch.float32
    _close(tout, jout, ENC_TOL * float(jnp.abs(jout).max()), "encode")
    jk, jv = jtfm._enc_kv_all(jp, jcfg, jout)
    tk, tv = tfm._enc_kv_all(tree_unbind(tp["blocks"]), tcfg, tout)
    for t_, j_, name in ((tk, jk, "cross k"), (tv, jv, "cross v")):
        assert j_.dtype == jnp.float32 and t_.dtype == torch.float32
        _close(t_, j_, ENC_TOL * float(jnp.abs(j_).max()), name)


def test_f32_frames_prefill_and_forward_match_reference():
    """The same f32 frames through a bf16 ``prefill`` and ``forward``:
    bf16 logits within bf16 rounding of the reference's, the cross K/V
    cast to the cache's dtype where the reference casts them, and a
    result other than the same frames given in bf16."""
    jcfg, tcfg = _bf16_cfgs()
    jp = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = to_torch(jp)
    fr = _frames(tcfg)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size,
                                             size=(2, 8)).astype(np.int32)
    tol = 3e-2
    jlg, jcache = jdec.prefill(jp, jcfg, jnp.asarray(toks),
                               enc_inputs=jnp.asarray(fr))
    tfr, ttoks = torch.from_numpy(fr), torch.from_numpy(toks).long()
    tlg, tcache = tdec.prefill(tp, tcfg, ttoks, enc_inputs=tfr)
    assert tlg.dtype == torch.bfloat16 and jlg.dtype == jnp.bfloat16
    scale = float(jnp.abs(jlg.astype(jnp.float32)).max())
    _close(tlg, jlg.astype(jnp.float32), tol * scale)
    for key in ("cross_k", "cross_v"):
        assert str(tcache[key].dtype).split(".")[-1] == str(jcache[key].dtype)
        scale = float(jnp.abs(jcache[key].astype(jnp.float32)).max())
        _close(tcache[key], jcache[key].astype(jnp.float32), tol * scale,
               key)
    jfw, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks),
                          enc_inputs=jnp.asarray(fr))
    tfw, _ = tfm.forward(tp, tcfg, ttoks, enc_inputs=tfr)
    assert tfw.dtype == torch.bfloat16
    scale = float(jnp.abs(jfw.astype(jnp.float32)).max())
    _close(tfw, jfw.astype(jnp.float32), tol * scale)
    lb, _ = tdec.prefill(tp, tcfg, ttoks, enc_inputs=tfr.bfloat16())
    assert not torch.equal(tlg, lb)
