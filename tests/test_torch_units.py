"""Port UnitMap and tree helpers against ``repro.core.units``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import units as jun  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import units as tun  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"rtol": 3e-3, "atol": 1e-5}


def _tree_close(a, b, **tol):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


def _vgg_shapes(cfg):
    return jax.eval_shape(lambda: jcnn.init_params(jax.random.PRNGKey(0),
                                                   cfg))


def _random_tree(shapes, rng, lead=()):
    return jax.tree.map(
        lambda s: rng.normal(size=lead + s.shape).astype(np.float32), shapes)


def _toy_stacked(rng, lead=()):
    """A tree with a stacked 'blocks' subtree (L=3) beside plain units."""
    shapes = {"blocks": {"w": (3, 4, 5), "b": (3, 5)},
              "embed": {"table": (7, 4)}, "head": {"w": (4, 2)}}
    return {k: {n: rng.normal(size=lead + s).astype(np.float32)
                for n, s in sub.items()} for k, sub in shapes.items()}


def test_unitmap_matches_reference_on_full_vgg9():
    """names, spans, unit_bytes and unit_params for the full-width VGG-9
    (built from zeros: no training)."""
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         _vgg_shapes(jcnn.VGGConfig()))
    ju = jun.UnitMap.build(zeros)
    tu = tun.UnitMap.build(params_from_numpy(zeros, "cpu"))
    assert tu.names == ju.names
    assert tu.spans == ju.spans
    assert tu.unit_bytes == ju.unit_bytes
    assert tu.unit_params == ju.unit_params
    assert tu.total_params == ju.total_params == 4_709_706
    assert tu.total_bytes == ju.total_bytes


def test_unitmap_stacked_subtree_matches_reference():
    tree = _toy_stacked(np.random.default_rng(0))
    ju, tu = (jun.UnitMap.build(tree),
              tun.UnitMap.build(params_from_numpy(tree, "cpu")))
    assert (tu.names, tu.spans, tu.unit_bytes, tu.unit_params) == \
        (ju.names, ju.spans, ju.unit_bytes, ju.unit_params)


def test_tree_leaves_walk_sorted_keys_like_jax():
    tree = {"z": {"b": np.ones(1), "a": np.zeros(2)}, "a": np.full(3, 2.0)}
    got = [l.shape for l in tun.tree_leaves(params_from_numpy(tree, "cpu"))]
    assert got == [tuple(l.shape) for l in jax.tree.leaves(tree)]


@pytest.mark.parametrize("tree_kind", ["vgg_reduced", "stacked"])
def test_sq_divergence_matches_reference(tree_kind):
    """Single model -> (U,); K client-stacked models -> (K, U), equal to the
    reference's per-client (vmapped) divergence."""
    rng = np.random.default_rng(1)
    k = 4
    if tree_kind == "vgg_reduced":
        shapes = _vgg_shapes(jcnn.VGGConfig().reduced())
        ref_np = _random_tree(shapes, rng)
        loc_np = _random_tree(shapes, rng, lead=(k,))
    else:
        ref_np = _toy_stacked(rng)
        loc_np = _toy_stacked(rng, lead=(k,))
    ju = jun.UnitMap.build(ref_np)
    tu = tun.UnitMap.build(params_from_numpy(ref_np, "cpu"))
    jref_p = jax.tree.map(jnp.asarray, ref_np)
    jloc = jax.tree.map(jnp.asarray, loc_np)
    tref_p, tloc = (params_from_numpy(ref_np, "cpu"),
                    params_from_numpy(loc_np, "cpu"))
    want = jax.vmap(lambda p: ju.sq_divergence(p, jref_p))(jloc)
    got = tu.sq_divergence(tloc, tref_p)
    assert got.shape == (k, tu.num_units)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tu.divergence(tloc, tref_p).numpy(),
        jax.vmap(lambda p: ju.divergence(p, jref_p))(jloc), **TOL)
    one = tun.tree_stack_index(tloc, 2)
    np.testing.assert_allclose(tu.sq_divergence(one, tref_p).numpy(),
                               ju.sq_divergence(
                                   jax.tree.map(lambda l: l[2], jloc),
                                   jref_p), **TOL)
    assert ops.launch_counts()["sqdiff_rowsum"] == 0


@pytest.mark.parametrize("tree_kind", ["vgg_reduced", "stacked"])
def test_accumulate_and_scale_by_unit_match_reference(tree_kind):
    rng = np.random.default_rng(2)
    if tree_kind == "vgg_reduced":
        shapes = _vgg_shapes(jcnn.VGGConfig().reduced())
        acc_np, x_np = _random_tree(shapes, rng), _random_tree(shapes, rng)
    else:
        acc_np, x_np = _toy_stacked(rng), _toy_stacked(rng)
    ju = jun.UnitMap.build(acc_np)
    w = rng.normal(size=(ju.num_units,)).astype(np.float32)
    jacc, jx = (jax.tree.map(jnp.asarray, acc_np),
                jax.tree.map(jnp.asarray, x_np))
    tacc, tx = params_from_numpy(acc_np, "cpu"), params_from_numpy(x_np, "cpu")
    tu = tun.UnitMap.build(tacc)
    want = ju.accumulate(jacc, jx, jnp.asarray(w))
    got = tu.accumulate(tacc, tx, torch.from_numpy(w))
    assert got is tacc                          # in place, as documented
    _tree_close(params_to_numpy(got), want, rtol=1e-6, atol=1e-6)
    _tree_close(params_to_numpy(tu.scale_by_unit(tx, torch.from_numpy(w))),
                ju.scale_by_unit(jx, jnp.asarray(w)), rtol=1e-6, atol=1e-6)


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(3)
    shapes = _vgg_shapes(jcnn.VGGConfig().reduced())
    a_np, b_np = _random_tree(shapes, rng), _random_tree(shapes, rng)
    ja, jb = jax.tree.map(jnp.asarray, a_np), jax.tree.map(jnp.asarray, b_np)
    ta, tb = params_from_numpy(a_np, "cpu"), params_from_numpy(b_np, "cpu")
    for tfn, jfn in [(tun.tree_add, jun.tree_add), (tun.tree_sub, jun.tree_sub)]:
        _tree_close(params_to_numpy(tfn(ta, tb)), jfn(ja, jb), rtol=1e-6)
    _tree_close(params_to_numpy(tun.tree_scale(ta, 0.3)),
                jun.tree_scale(ja, 0.3), rtol=1e-6)
    _tree_close(params_to_numpy(tun.tree_axpy(ta, tb, -1.5)),
                jun.tree_axpy(ja, jb, -1.5), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tun.tree_dot(ta, tb)),
                               float(jun.tree_dot(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(tun.tree_sq_norm(ta)),
                               float(jun.tree_sq_norm(ja)), rtol=1e-5)
    assert tun.tree_bytes(ta) == jun.tree_bytes(ja)
    assert tun.tree_params(ta) == jun.tree_params(ja)
    z = tun.tree_zeros_like(ta, dtype=torch.float64)
    assert all(l.dtype == torch.float64 and not l.any()
               for l in tun.tree_leaves(z))
    assert all(l.dtype == torch.bfloat16 for l in
               tun.tree_leaves(tun.tree_cast(ta, torch.bfloat16)))
