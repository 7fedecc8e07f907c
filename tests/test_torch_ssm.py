"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) and the ``ssm``
and ``hybrid`` block kinds against the reference on the CPU, in f32, with
the reference's weights carried across by ``bridge.params_from_numpy``:
``ssd_fwd`` (with and without its cache), ``_causal_conv`` and
``ssd_step`` against ``repro.models.ssm``; the chunked form against the
port's own token-by-token recurrence; the two kinds' parameter trees;
``lm_loss`` and its gradient against ``jax.value_and_grad`` (also under
``torch.func.vmap(grad_and_value)``); ``inject_lora``'s paths; and one
fedldf round of each kind's ``reduced()`` config, as
tests/test_arch_smoke.py runs it for the reference."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from test_torch_engine import LOSS_TOL, PARAM_TOL, max_diff, to_torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.units import UnitMap as JUnitMap  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import build_round_scan as jbuild_round_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.lora import inject_lora as jinject  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import leaf_paths  # noqa: E402
from repro_torch.core.units import UnitMap  # noqa: E402
from repro_torch.federated import FLConfig, build_round_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lora import inject_lora, lora_partition  # noqa: E402

SSD_TOL = 1e-5
LOSS_GRAD_TOL, GRAD_TOL = 1e-5, 2e-5          # tests/test_torch_lora.py
# tests/test_decode_consistency.py:28-29
TINY = dict(name="t-ssm", family="ssm", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=97, ssm_state=8, ssm_head_dim=16, ssm_chunk=8)


# the reference's mixer, compiled once per config (it is hashable)
jssd_fwd = jax.jit(jssm.ssd_fwd, static_argnums=2,
                   static_argnames=("return_cache",))
jssd_step = jax.jit(jssm.ssd_step, static_argnums=3)


def _cfgs(family="ssm", **kw):
    base = {**TINY, "name": "t-" + family, "family": family, **kw}
    return JModelConfig(**base), ModelConfig(**base)


def _reduced_f32(arch):
    def f32(c):
        return dataclasses.replace(c.reduced(), param_dtype="float32",
                                   compute_dtype="float32")
    return f32(jget_config(arch)), f32(get_config(arch))


@pytest.fixture(scope="module")
def mixer():
    """The reference's SSD mixer leaves (the conv bias, the SSD vectors and
    the norm scale perturbed off their constant init, so every leaf
    matters) and the same numbers in the port."""
    jcfg, tcfg = _cfgs()
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    for name in ("conv_b", "A_log", "D_skip", "dt_bias", "norm_scale"):
        jp[name] = jp[name] + 0.1 * rng.normal(
            size=jp[name].shape).astype(np.float32)
    return jcfg, tcfg, jp, to_torch(jp)


def _close(got, want, tol=SSD_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=msg)


# ----------------------------------------------------------------------
# the mixer against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("s", [13, 16, 2])   # ragged chunk; 2 chunks; < W-1
def test_ssd_fwd_and_conv_match_reference(mixer, s):
    jcfg, tcfg, jp, tp = mixer
    x = np.random.default_rng(s).normal(size=(2, s, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(tssm.ssd_fwd(tp, tx, tcfg).numpy(), jssd_fwd(jp, jx, jcfg))
    tout, tcache = tssm.ssd_fwd(tp, tx, tcfg, return_cache=True)
    jout, jcache = jssd_fwd(jp, jx, jcfg, return_cache=True)
    _close(tout.numpy(), jout, msg="out")
    _close(tcache["state"].numpy(), jcache["state"], msg="state")
    _close(tcache["conv"].numpy(), jcache["conv"], msg="conv")
    assert tcache["conv"].shape == (2, 3, 64 * 2 + 16)
    _, txbc, _ = tssm._split_proj(tp, tx, tcfg)
    _, jxbc, _ = jssm._split_proj(jp, jx, jcfg)
    _close(txbc.numpy(), jxbc)
    _close(tssm._causal_conv(tp, txbc, tcfg).numpy(),
           jssm._causal_conv(jp, jxbc, jcfg), msg="conv out")


@pytest.mark.parametrize("s", [13, 16, 2])
def test_ssd_step_matches_reference(mixer, s):
    """Token by token from a zero cache, each step's output and cache
    against the reference's ssd_step on the same cache."""
    jcfg, tcfg, jp, tp = mixer
    x = np.random.default_rng(s + 1).normal(size=(2, s, 64)) \
        .astype(np.float32)
    jcache = jssm.init_ssm_cache(jcfg, 2)
    tcache = tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    for t in range(s):
        jout, jcache = jssd_step(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                 jcfg)
        tout, tcache = tssm.ssd_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                     tcache, tcfg)
        _close(tout.numpy(), jout, msg=f"step {t}")
        _close(tcache["state"].numpy(), jcache["state"], msg=f"state {t}")
        _close(tcache["conv"].numpy(), jcache["conv"], msg=f"conv {t}")


@pytest.mark.parametrize("s", [13, 16, 2, 40])
def test_ssd_fwd_matches_its_own_recurrence(mixer, s):
    """The chunked dual form against the port's ssd_step loop (an
    independent plain reference of the same module): outputs, final state
    and conv tail."""
    _, tcfg, _, tp = mixer
    x = torch.from_numpy(np.random.default_rng(s + 2).normal(
        size=(2, s, 64)).astype(np.float32))
    out, cache = tssm.ssd_fwd(tp, x, tcfg, return_cache=True)
    step = tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(s):
        o, step = tssm.ssd_step(tp, x[:, t:t + 1], step, tcfg)
        outs.append(o)
    _close(torch.cat(outs, dim=1).numpy(), out.numpy())
    _close(step["state"].numpy(), cache["state"].numpy())
    _close(step["conv"].numpy(), cache["conv"].numpy())


def test_ssd_fwd_gradient_is_finite_where_the_decay_overflows(mixer):
    """With dt ~ 20 a chunk of 8 spans exp(cum_i - cum_j) up to e^140 for
    j > i: the reference's exp-then-mask overflows there and its gradient
    is NaN; the port masks the exponent first, so the forward equals the
    reference's and every gradient is finite."""
    jcfg, tcfg, jp, tp = mixer
    jp = {**jp, "dt_bias": jnp.full_like(jp["dt_bias"], 20.0)}
    tp = {**tp, "dt_bias": torch.full_like(tp["dt_bias"], 20.0)}
    x = np.random.default_rng(5).normal(size=(1, 16, 64)).astype(np.float32)
    _close(tssm.ssd_fwd(tp, torch.from_numpy(x), tcfg).numpy(),
           jssd_fwd(jp, jnp.asarray(x), jcfg))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jssm.ssd_fwd(
        p, jnp.asarray(x), jcfg))))(jp)
    assert not np.isfinite(np.asarray(jg["A_log"])).all()
    tg = torch.func.grad(lambda p: tssm.ssd_fwd(
        p, torch.from_numpy(x), tcfg).sum())(tp)
    for path, g in leaf_paths(tg):
        assert bool(torch.isfinite(g).all()), path


# ----------------------------------------------------------------------
# the block kinds
# ----------------------------------------------------------------------
def _tree(params):
    return {p: (tuple(np.shape(x)), str(x.dtype).replace("torch.", ""))
            for p, x in leaf_paths(params)}


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_reference_tree(family, dtype):
    """Paths, shapes and dtypes (A_log, D_skip and dt_bias in f32 in a
    bf16 model); the ssm kind has no ln2, mlp or attn."""
    jcfg, tcfg = _cfgs(family, param_dtype=dtype, compute_dtype=dtype)
    jp = jax.tree.map(np.asarray,
                      jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree(tp) == _tree(jp)
    assert set(tp["blocks"]) == ({"ln1", "ssm"} if family == "ssm" else
                                 {"ln1", "attn", "ssm", "ln2", "mlp"})
    ssm = tp["blocks"]["ssm"]
    assert float(ssm["dt_bias"].min()) == float(ssm["dt_bias"].max()) == -2.0
    assert not ssm["A_log"].any() and bool((ssm["D_skip"] == 1).all())
    assert not ssm["conv_b"].any()
    std = float(ssm["conv_w"].float().std())
    assert 0.08 < std < 0.12


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_inject_lora_paths_match_reference(family):
    """in_proj/out_proj of the SSD (and the attention and MLP projections
    of the hybrid) get adapters, with the reference's paths and shapes."""
    jcfg, tcfg = _cfgs(family)
    jp = jinject(jax.random.PRNGKey(1),
                 jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=4)
    tp = inject_lora(tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                                      "cpu"), 4,
                     torch.Generator().manual_seed(1))
    assert _tree(tp) == _tree(jax.tree.map(np.asarray, jp))
    assert set(tp["blocks"]["ssm"]["lora"]) == {"in_proj", "out_proj"}
    paths = lora_partition(tp).trainable_paths
    assert len(paths) == (4 if family == "ssm" else 18)


def _lm_batch(vocab, lead=(3,)):
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, size=lead + (19,)).astype(np.int32),
            rng.integers(0, vocab, size=lead + (19,)).astype(np.int32))


@pytest.fixture(scope="module", params=["ssm", "hybrid"])
def lm(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, l: l + 0.1 * rng.normal(size=l.shape).astype(np.float32)
        if path[-1].key in ("A_log", "D_skip", "dt_bias", "conv_b") else l,
        jp)
    return jcfg, tcfg, jp, to_torch(jp)


def _jloss_grad(jcfg, jp, tokens, labels):
    return jax.jit(jax.value_and_grad(lambda p: jtfm.lm_loss(
        p, jcfg, {"tokens": tokens, "labels": labels})))(jp)


def _assert_grads(tgrads, jgrads):
    want = dict(leaf_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(leaf_paths(params_to_numpy(tgrads)))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=GRAD_TOL,
                                   rtol=0, err_msg=path)


def test_lm_loss_and_grad_match_reference(lm):
    """Every leaf's gradient, SSD constants included (seq 19: two chunks
    of 8 and a ragged third)."""
    jcfg, tcfg, jp, tp = lm
    tokens, labels = _lm_batch(tcfg.vocab_size)
    jloss, jgrads = _jloss_grad(jcfg, jp, jnp.asarray(tokens),
                                jnp.asarray(labels))
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    tgrads, tloss = grad_and_value(
        lambda p: tfm.lm_loss(p, tcfg, batch))(tp)
    assert abs(float(tloss) - float(jloss)) <= LOSS_GRAD_TOL
    _assert_grads(tgrads, jgrads)


def test_lm_loss_and_grad_under_vmap_match_reference(lm):
    """Two clients' batches under vmap(grad_and_value), the model shared,
    each against the reference's value_and_grad on its own batch."""
    jcfg, tcfg, jp, tp = lm
    tokens, labels = _lm_batch(tcfg.vocab_size, lead=(2, 2))
    tgrads, tloss = vmap(grad_and_value(lambda p, b: tfm.lm_loss(p, tcfg, b)),
                         in_dims=(None, 0))(
        tp, {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})
    for i in range(2):
        jloss, jgrads = _jloss_grad(jcfg, jp, jnp.asarray(tokens[i]),
                                    jnp.asarray(labels[i]))
        assert abs(float(tloss[i]) - float(jloss)) <= LOSS_GRAD_TOL
        _assert_grads(jax.tree.map(lambda g: g[i], tgrads), jgrads)


# ----------------------------------------------------------------------
# one fedldf round of each reduced config (tests/test_arch_smoke.py:66)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_fedldf_round_of_reduced_config_matches_reference(arch):
    """FedLDF in scan mode, 4 clients, K = 3, top-2, lr 0.01, on the
    reference's params and its client batches (seq 24: chunks of 16, the
    second ragged)."""
    jcfg, tcfg = _reduced_f32(arch)
    k = 3
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    key = jax.random.PRNGKey(0)
    jbatch = {"tokens": jax.random.randint(key, (k, 2, 24), 0,
                                           jcfg.vocab_size),
              "labels": jax.random.randint(key, (k, 2, 24), 0,
                                           jcfg.vocab_size)}
    kw = dict(algo="fedldf", num_clients=4, clients_per_round=k, top_n=2,
              lr=0.01, mode="scan")
    jround = jax.jit(jbuild_round_scan(
        lambda p, b: jtfm.lm_loss(p, jcfg, b), JUnitMap.build(jparams),
        JFLConfig(**kw)))
    jnew, jmet = jround(jparams, jbatch, jnp.ones((k,)), key)
    tparams = to_torch(jparams)
    tround = build_round_scan(tfm.make_lm_loss(tcfg), UnitMap.build(tparams),
                              FLConfig(**kw))
    tnew, tmet = tround(tparams, {n: torch.from_numpy(np.array(v))
                                  for n, v in jbatch.items()},
                        torch.ones(k))
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    np.testing.assert_array_equal(np.asarray(tmet["selection"]),
                                  np.asarray(jmet["selection"]))
    assert max_diff(tnew, jax.tree.map(np.asarray, jnew)) <= PARAM_TOL
    assert max_diff(tnew, jax.tree.map(np.asarray, jparams)) > 0.0
