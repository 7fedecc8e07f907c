"""The port's MoE layer (``repro_torch.models.moe``) and the ``moe`` block
kind against the reference on the CPU, in f32, with the reference's
weights carried across by ``bridge.params_from_numpy``: ``_capacity``;
``moe_fwd``'s output and balance loss at capacity factors 1.25 and 0.5
(choices dropped) for top-2 with a shared expert (deepseek-moe-16b
reduced) and top-1 (llama4-maverick-400b-a17b reduced), and on routers
whose probabilities tie exactly; both against a per-expert loop written
independently of both packages (``tests/torch_moe_loop.py``); the
parameter trees against ``jax.eval_shape``; ``lm_loss`` and every leaf's
gradient against ``jax.value_and_grad`` (also under
``torch.func.vmap(grad_and_value)``); ``remat_blocks`` bit for bit;
``inject_lora``'s paths; and one fedldf round of the reduced config in
vmap and scan mode on the reference's params and client batches."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from test_torch_engine import LOSS_TOL, PARAM_TOL, max_diff, to_torch  # noqa: E402
from test_torch_ssm import (LOSS_GRAD_TOL, _assert_grads,  # noqa: E402
                            _jloss_grad, _tree)
from torch_moe_loop import moe_loop  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.units import UnitMap as JUnitMap  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import build_round_scan as jbuild_round_scan  # noqa: E402
from repro.federated import build_round_vmap as jbuild_round_vmap  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.lora import inject_lora as jinject  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import leaf_paths  # noqa: E402
from repro_torch.core.units import UnitMap  # noqa: E402
from repro_torch.federated import (FLConfig, build_round_scan,  # noqa: E402
                                   build_round_vmap)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lora import inject_lora, lora_partition  # noqa: E402

MOE_TOL = 1e-5
ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")   # top-2, top-1

# the reference's layer, compiled once per config (it is hashable)
jmoe_fwd = jax.jit(jmoe.moe_fwd, static_argnums=2)


def _reduced_f32(arch, **kw):
    def f32(c):
        return dataclasses.replace(c.reduced(), param_dtype="float32",
                                   compute_dtype="float32", **kw)
    return f32(jget_config(arch)), f32(get_config(arch))


def _layer(jcfg, seed=0):
    """The reference's moe leaves and the same numbers in the port."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, to_torch(jp)


def _close(got, want, tol=MOE_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _check_layer(jcfg, tcfg, jp, tp, x):
    """moe_fwd's out and aux against the reference's and the loop's;
    returns the loop's count of dropped choices."""
    jout, jaux = jmoe_fwd(jp, jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe_fwd(tp, torch.from_numpy(x), tcfg)
    lout, laux, dropped = moe_loop(tp, torch.from_numpy(x), tcfg)
    assert tout.dtype == torch.float32 and taux.dtype == torch.float32
    _close(tout.numpy(), jout, msg="out vs reference")
    _close(float(taux), float(jaux), msg="aux vs reference")
    _close(tout.numpy(), lout.numpy(), msg="out vs loop")
    _close(float(taux), float(laux), msg="aux vs loop")
    return dropped


# ----------------------------------------------------------------------
# the layer against the reference and the loop
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0, 11.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch, cf):
    jcfg, tcfg = _reduced_f32(arch, capacity_factor=cf)
    full = dataclasses.replace(get_config(arch), capacity_factor=cf)
    jfull = dataclasses.replace(jget_config(arch), capacity_factor=cf)
    for t in (1, 2, 4, 7, 26, 34, 8192, 8320):
        assert tmoe._capacity(t, tcfg) == jmoe._capacity(t, jcfg)
        assert tmoe._capacity(t, full) == jmoe._capacity(t, jfull)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fwd_matches_reference_and_loop(arch, cf):
    """At 0.5 some choices must be dropped (the test asserts it)."""
    jcfg, tcfg = _reduced_f32(arch, capacity_factor=cf)
    jp, tp = _layer(jcfg)
    x = np.random.default_rng(1).normal(size=(2, 13, 128)).astype(np.float32)
    dropped = _check_layer(jcfg, tcfg, jp, tp, x)
    _, _, pos, gates = tmoe.route(tp, torch.from_numpy(x).reshape(26, 128),
                                  tcfg, tmoe._capacity(26, tcfg))
    assert int((pos >= tmoe._capacity(26, tcfg)).sum()) == dropped
    assert int((gates == 0).sum()) == dropped
    if cf == 0.5:
        assert dropped > 0


@pytest.mark.parametrize("tie", ["all", "four"])
def test_moe_fwd_ties_go_to_the_lower_index(tie):
    """Routers whose probabilities tie exactly: all E experts (a zero
    router), or experts 1, 2, 3 and 5 of 6 above 0 and 4 (the two others'
    logits negative), as ``[0.1, .3, .3, .3, 0, .3]``; top-3 takes the
    lowest indices, as ``jax.lax.top_k`` does, and the capacity then drops
    the later tokens' choices."""
    base = dict(name="t-moe", family="moe", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0,
                vocab_size=97, num_experts=6, moe_top_k=3, moe_d_ff=16,
                num_shared_experts=1, capacity_factor=1.25)
    jcfg, tcfg = JModelConfig(**base), ModelConfig(**base)
    jp, _ = _layer(jcfg)
    router = np.zeros((32, 6), np.float32)
    if tie == "four":
        router[:, 0], router[:, 4] = -0.05, -0.1
    jp = {**jp, "router": jnp.asarray(router)}
    tp = to_torch(jp)
    x = np.abs(np.random.default_rng(2).normal(size=(2, 9, 32))) \
        .astype(np.float32)
    dropped = _check_layer(jcfg, tcfg, jp, tp, x)
    _, eidx, _, _ = tmoe.route(tp, torch.from_numpy(x).reshape(18, 32), tcfg,
                               tmoe._capacity(18, tcfg))
    want = [0, 1, 2] if tie == "all" else [1, 2, 3]
    assert (eidx == torch.tensor(want)).all()
    assert dropped == 3 * (18 - tmoe._capacity(18, tcfg)) > 0


# ----------------------------------------------------------------------
# the block kind
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch, dtype):
    """Paths, shapes and dtypes against ``jax.eval_shape`` of the
    reference's init (the router in f32 in a bf16 model); an moe block has
    ``moe`` and no ``mlp``; the expert banks' std is ``1/sqrt(d_in)``."""
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype,
                              compute_dtype=dtype)
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               param_dtype=dtype, compute_dtype=dtype)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree(tp) == _tree(shapes)
    assert set(tp["blocks"]) == {"ln1", "attn", "ln2", "moe"}
    moe = tp["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert ("shared" in moe) == (cfg.num_shared_experts > 0)
    for name, d_in in (("w_gate", cfg.d_model), ("w_up", cfg.d_model),
                       ("w_down", cfg.moe_d_ff)):
        std = float(moe[name].float().std()) * d_in ** 0.5
        assert 0.95 < std < 1.05, name


def test_inject_lora_paths_match_reference():
    """Adapters on the attention projections only: the expert banks and
    the shared experts (``moe/shared``) get none, as in the reference."""
    jcfg, tcfg = _reduced_f32("deepseek-moe-16b")
    jp = jinject(jax.random.PRNGKey(1),
                 jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=4)
    tp = inject_lora(tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                                      "cpu"), 4,
                     torch.Generator().manual_seed(1))
    assert _tree(tp) == _tree(jax.tree.map(np.asarray, jp))
    assert set(tp["blocks"]["attn"]["lora"]) == {"wq", "wk", "wv", "wo"}
    assert not any("lora" in p for p, _ in leaf_paths(tp["blocks"]["moe"]))
    assert len(lora_partition(tp).trainable_paths) == 8


def _lm_batch(vocab, lead=(3,)):
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, size=lead + (11,)).astype(np.int32),
            rng.integers(0, vocab, size=lead + (11,)).astype(np.int32))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg, tcfg = _reduced_f32(request.param)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, to_torch(jp)


def test_forward_aux_matches_reference(lm):
    """The balance loss summed over the layers, and lm_loss's 0.01·aux."""
    jcfg, tcfg, jp, tp = lm
    tokens, labels = _lm_batch(tcfg.vocab_size)
    _, jaux = jtfm.forward(jp, jcfg, jnp.asarray(tokens))
    _, taux = tfm.forward(tp, tcfg, torch.from_numpy(tokens))
    assert taux.dtype == torch.float32 and float(taux) > 0.0
    assert abs(float(taux) - float(jaux)) <= MOE_TOL


def test_lm_loss_and_grad_match_reference(lm):
    """Every leaf's gradient, the router's and the expert banks' included
    (3 × 11 tokens: the capacity drops choices)."""
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


def _vmap_grads(tcfg, tp, tokens, labels):
    return vmap(grad_and_value(lambda p, b: tfm.lm_loss(p, tcfg, b)),
                in_dims=(None, 0))(
        tp, {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


def test_lm_loss_and_grad_under_vmap_match_reference(lm):
    """Two clients' batches under vmap(grad_and_value), the model shared,
    each against the reference's value_and_grad on its own batch."""
    jcfg, tcfg, jp, tp = lm
    tokens, labels = _lm_batch(tcfg.vocab_size, lead=(2, 2))
    tgrads, tloss = _vmap_grads(tcfg, tp, tokens, labels)
    for i in range(2):
        jloss, jgrads = _jloss_grad(jcfg, jp, jnp.asarray(tokens[i]),
                                    jnp.asarray(labels[i]))
        assert abs(float(tloss[i]) - float(jloss)) <= LOSS_GRAD_TOL
        _assert_grads(jax.tree.map(lambda g: g[i], tgrads), jgrads)


def test_remat_blocks_is_bit_identical_under_vmap_grad(lm):
    """An moe block under remat has two outputs (x, aux): its backward
    takes both cotangents."""
    _, tcfg, _, tp = lm
    tokens, labels = _lm_batch(tcfg.vocab_size, lead=(2, 2))
    g0, l0 = _vmap_grads(tcfg, tp, tokens, labels)
    g1, l1 = _vmap_grads(dataclasses.replace(tcfg, remat_blocks=True), tp,
                         tokens, labels)
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(leaf_paths(g0), leaf_paths(g1)):
        assert torch.equal(a, b), p


# ----------------------------------------------------------------------
# one fedldf round of the reduced config (tests/test_arch_smoke.py:66)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_fedldf_round_of_reduced_config_matches_reference(mode):
    """deepseek-moe-16b reduced, fedldf with 4 clients, K = 3, top-2, lr
    0.01, on the reference's params and its client batches."""
    jcfg, tcfg = _reduced_f32("deepseek-moe-16b")
    k = 3
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    key = jax.random.PRNGKey(0)
    jbatch = {"tokens": jax.random.randint(key, (k, 2, 12), 0,
                                           jcfg.vocab_size),
              "labels": jax.random.randint(key, (k, 2, 12), 0,
                                           jcfg.vocab_size)}
    kw = dict(algo="fedldf", num_clients=4, clients_per_round=k, top_n=2,
              lr=0.01, mode=mode)
    jbuild, tbuild = {"vmap": (jbuild_round_vmap, build_round_vmap),
                      "scan": (jbuild_round_scan, build_round_scan)}[mode]
    jround = jax.jit(jbuild(lambda p, b: jtfm.lm_loss(p, jcfg, b),
                            JUnitMap.build(jparams), JFLConfig(**kw)))
    jnew, jmet = jround(jparams, jbatch, jnp.ones((k,)), key)
    tparams = to_torch(jparams)
    tround = tbuild(tfm.make_lm_loss(tcfg), UnitMap.build(tparams),
                    FLConfig(**kw))
    tnew, tmet = tround(tparams, {n: torch.from_numpy(np.array(v))
                                  for n, v in jbatch.items()},
                        torch.ones(k))
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    np.testing.assert_array_equal(np.asarray(tmet["selection"]),
                                  np.asarray(jmet["selection"]))
    assert max_diff(tnew, jax.tree.map(np.asarray, jnew)) <= PARAM_TOL
    assert max_diff(tnew, jax.tree.map(np.asarray, jparams)) > 0.0
