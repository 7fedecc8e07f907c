"""The gradient of the stacked block leaves (``models/transformer.py``
unbinds each stacked leaf once a forward, and ``_run_stack`` and
``_enc_kv_all`` read its views) on the CPU, for every block kind at
reduced width, ``remat_blocks`` off and on:

- every leaf's gradient under ``torch.func.grad`` and under
  ``vmap(grad, in_dims=(None, 0))`` is ``torch.equal`` to the one of the
  former form, which took each layer as a slice ``leaf[l]``
  (:func:`slice_layers`, patched in as ``tree_unbind``): each slot of a
  stacked gradient gets exactly one non-zero term in both forms;
- the backward writes a stacked leaf's full shape once, with one
  ``stack``, where the slice form filled and added L full-size gradients
  (``select_backward`` and ``add``; the slice form's counts are checked
  too, so the probe is seen to see them)."""
import dataclasses
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.func import grad, vmap  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.units import (tree_leaves, tree_stack_index,  # noqa: E402
                                    tree_unbind)
from repro_torch.models import transformer as tfm  # noqa: E402

KINDS = {"dense": "qwen3-1.7b", "moe": "deepseek-moe-16b",
         "ssm": "mamba2-780m", "hybrid": "hymba-1.5b",
         "enc-dec": "seamless-m4t-large-v2"}
LAYERS = 3              # no activation of the batch below has (3, ...)
B, S, S_ENC, K = 2, 11, 7, 2
STACKED = ("blocks", "enc_blocks")


def slice_layers(tree):
    """The former split of a stacked tree into layers: a slice a leaf a
    layer (``tree_stack_index``), whose backward is ``select_backward``."""
    return [tree_stack_index(tree, l)
            for l in range(tree_leaves(tree)[0].shape[0])]


def small_model(kind: str, layers: int = LAYERS, **kw):
    """The kind's reduced config at ``layers`` layers (and as many encoder
    layers), f32, and its weights."""
    base = get_config(KINDS[kind])
    cfg = dataclasses.replace(
        base.reduced(), num_layers=layers,
        encoder_layers=layers if base.is_encdec else 0,
        param_dtype="float32", compute_dtype="float32", **kw)
    return cfg, tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def batch_for(cfg, lead=(), device="cpu", seq=S, seed=1):
    """A seeded batch of B sequences (``lead`` clients ahead of it)."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (*lead, B, seq), generator=g)
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=-1)}
    if cfg.is_encdec:
        batch["enc_inputs"] = torch.randn(*lead, B, S_ENC, cfg.frontend_dim,
                                          generator=g)
    return {k: v.to(device) for k, v in batch.items()}


def stacked_shapes(params) -> Counter:
    """How many stacked leaves have each full shape."""
    return Counter(tuple(l.shape) for key in STACKED if key in params
                   for l in tree_leaves(params[key]))


class FullSizeOps(TorchDispatchMode):
    """Counts the ops whose output has one of ``shapes``, by op name."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.ops = set(shapes), Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor) and tuple(o.shape) in self.shapes:
                self.ops[func.overloadpacket.__name__] += 1
        return out


def _grads(cfg, params, batch, transform):
    def loss(p, b):
        return tfm.lm_loss(p, cfg, b)
    if transform == "grad":
        return grad(loss)(params, batch)
    return vmap(grad(loss), in_dims=(None, 0))(params, batch)


def test_tree_unbind_gives_tree_stack_index_views():
    tree = {"a": torch.arange(24.).reshape(3, 8), "b": {"c": torch.ones(3)}}
    layers = tree_unbind(tree)
    assert len(layers) == 3
    for l, layer in enumerate(layers):
        want = tree_stack_index(tree, l)
        assert list(layer) == list(want) and list(layer["b"]) == ["c"]
        for got, ref in zip(tree_leaves(layer), tree_leaves(want)):
            assert got._base is not None and torch.equal(got, ref)
    assert [t.tolist() for t in tree_unbind(torch.arange(3.))] == [0., 1., 2.]


@pytest.mark.parametrize("transform", ["grad", "vmap"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_grads_equal_the_slice_form(kind, remat, transform,
                                            monkeypatch):
    cfg, params = small_model(kind, remat_blocks=remat)
    batch = batch_for(cfg, lead=() if transform == "grad" else (K,))
    got = _grads(cfg, params, batch, transform)
    monkeypatch.setattr(tfm, "tree_unbind", slice_layers)
    want = _grads(cfg, params, batch, transform)
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want) == len(tree_leaves(params))
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert any(bool(g.abs().sum() > 0) for g in got)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_backward_writes_each_stacked_leaf_once(kind, remat, monkeypatch):
    cfg, params = small_model(kind, remat_blocks=remat)
    batch = batch_for(cfg)
    shapes = stacked_shapes(params)
    n = sum(shapes.values())
    with FullSizeOps(shapes) as probe:
        _grads(cfg, params, batch, "grad")
    assert probe.ops == Counter(stack=n)
    monkeypatch.setattr(tfm, "tree_unbind", slice_layers)
    with FullSizeOps(shapes) as probe:
        _grads(cfg, params, batch, "grad")
    assert probe.ops["select_backward"] == LAYERS * n
    assert probe.ops["add"] == (LAYERS - 1) * n
    assert probe.ops["stack"] == 0
