"""The port's low-rank delta upload (``repro_torch.core.lowrank``) and
``quantized_bytes_per_param`` against the reference: every case of
tests/test_lowrank.py, with the reference's start subspaces (its
``jax.random`` draws) injected through ``start=`` / ``starts=`` where the
two packages are compared value for value, and the port's own
``torch.Generator`` threading where a case is about the draw."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import to_torch  # noqa: E402

from repro.core import compress as jcompress  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import lowrank as tlr  # noqa: E402
from repro_torch.core.partition import leaf_paths  # noqa: E402

TOL = {"rtol": 1e-4, "atol": 1e-4}          # tests/test_lowrank.py:17
PARITY = {"rtol": 1e-4, "atol": 2e-5}       # f32 QR in two LAPACK calls


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(_np(x).copy())


def _jstart(key, n, r):
    """The reference's start subspace for ``key`` (PRNGKey(0) for None)."""
    key = jax.random.PRNGKey(0) if key is None else key
    return _t(jax.random.normal(key, (n, r), jnp.float32))


def _jstarts(tree, rank, key=None, min_dim=32):
    """The starts ``repro.core.lowrank.lowrank_upload`` draws, one entry a
    leaf in sorted-path order (fold_in(key, i), then a split a slice)."""
    out = []
    for i, (_, leaf) in enumerate(leaf_paths(tree)):
        if leaf.ndim < 2 or min(leaf.shape[-2:]) < min_dim:
            out.append(None)
            continue
        n = leaf.shape[-1]
        r = min(rank, *leaf.shape[-2:])
        lk = None if key is None else jax.random.fold_in(key, i)
        if leaf.ndim == 2:
            out.append(_jstart(lk, n, r))
            continue
        lead = int(np.prod(leaf.shape[:-2]))
        ks = ([None] * lead if lk is None
              else list(jax.random.split(lk, lead)))
        out.append(torch.stack([_jstart(k, n, r) for k in ks]))
    return out


def _approx_pair(m, rank, iters, key=None):
    """(port, reference) rank-r approximations from the same start."""
    want = jlr._lowrank_approx(m, rank=rank, iters=iters, key=key)
    r = min(rank, *m.shape)
    got = tlr._lowrank_approx(_t(m), rank, iters=iters,
                              start=_jstart(key, m.shape[1], r))
    return got, _np(want)


def test_exact_when_rank_suffices():
    """A true rank-3 matrix is recovered exactly at rank ≥ 3."""
    u = jax.random.normal(jax.random.PRNGKey(0), (40, 3))
    v = jax.random.normal(jax.random.PRNGKey(1), (3, 50))
    m = u @ v
    got, want = _approx_pair(m, 3, 3)
    np.testing.assert_allclose(got.numpy(), _np(m), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **PARITY)


def test_approx_error_decreases_with_rank():
    m = jax.random.normal(jax.random.PRNGKey(2), (64, 64))
    errs = []
    for r in (2, 8, 32, 64):
        got, want = _approx_pair(m, r, 3)
        np.testing.assert_allclose(got.numpy(), want, **PARITY)
        errs.append(float(torch.linalg.norm(_t(m) - got)))
    assert errs[0] > errs[1] > errs[2]
    assert errs[3] < 1e-3  # full rank ⇒ exact


def test_generator_default_is_the_fixed_start():
    """No generator is the fixed start of a generator seeded 0, bit for
    bit (the reference's key=None is its PRNGKey(0) start)."""
    m = _t(jax.random.normal(jax.random.PRNGKey(4), (48, 40)))
    legacy = tlr._lowrank_approx(m, rank=5, iters=2)
    seeded = tlr._lowrank_approx(m, rank=5, iters=2,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(legacy, seeded)
    got, want = _approx_pair(jax.random.normal(jax.random.PRNGKey(4),
                                               (48, 40)), 5, 2)
    np.testing.assert_allclose(got.numpy(), want, **PARITY)


def test_generator_threading_quality_unchanged_on_fixed_seeds():
    """Another start changes the sketch, not the truncation quality."""
    u = _t(jax.random.normal(jax.random.PRNGKey(5), (40, 3)))
    v = _t(jax.random.normal(jax.random.PRNGKey(6), (3, 50)))
    m = u @ v
    for s in (7, 8, 9):   # exact recovery for any sketch seed
        a = tlr._lowrank_approx(m, 3, iters=3,
                                generator=torch.Generator().manual_seed(s))
        np.testing.assert_allclose(a.numpy(), m.numpy(), **TOL)
    full = _t(jax.random.normal(jax.random.PRNGKey(10), (64, 64)))
    base = float(torch.linalg.norm(full - tlr._lowrank_approx(full, 8,
                                                              iters=3)))
    for s in (11, 12):
        e = float(torch.linalg.norm(full - tlr._lowrank_approx(
            full, 8, iters=3, generator=torch.Generator().manual_seed(s))))
        assert abs(e - base) < 0.2 * base


def _check_residual_identity(theta, local, g, res, atol=1e-5):
    for (p, t), (_, l_), (_, gg), (_, r) in zip(
            leaf_paths(theta), leaf_paths(local), leaf_paths(g),
            leaf_paths(res)):
        np.testing.assert_allclose((t - gg + r).numpy(), (l_ - gg).numpy(),
                                   atol=atol, err_msg=p)


def test_upload_generator_is_deterministic_and_decorrelates():
    jg = {"w": jnp.zeros((48, 48)), "s": jnp.zeros((48, 2, 40, 40))}
    jlocal = jax.tree.map(
        lambda l: jax.random.normal(jax.random.PRNGKey(13), l.shape), jg)
    g, local = to_torch(jg), to_torch(jlocal)
    th1, r1 = tlr.lowrank_upload(local, g, rank=2,
                                 generator=torch.Generator().manual_seed(14))
    th2, _ = tlr.lowrank_upload(local, g, rank=2,
                                generator=torch.Generator().manual_seed(14))
    for (_, a), (_, b) in zip(leaf_paths(th1), leaf_paths(th2)):
        assert torch.equal(a, b)
    th3, _ = tlr.lowrank_upload(local, g, rank=2,
                                generator=torch.Generator().manual_seed(15))
    assert not torch.equal(th1["w"], th3["w"])
    _check_residual_identity(th1, local, g, r1)
    # the reference's keyed starts injected: its values, leaf by leaf
    k = jax.random.PRNGKey(14)
    jth, jres = jlr.lowrank_upload(jlocal, jg, rank=2, key=k)
    th, res = tlr.lowrank_upload(local, g, rank=2,
                                 starts=_jstarts(g, 2, key=k))
    for got, want in ((th, jth), (res, jres)):
        for (p, a), (_, b) in zip(leaf_paths(params_to_numpy(got)),
                                  leaf_paths(jax.tree.map(_np, want))):
            np.testing.assert_allclose(a, b, err_msg=p, **PARITY)


def test_upload_roundtrip_and_residual():
    cfg = jcnn.VGGConfig().reduced()
    jg = jcnn.init_params(jax.random.PRNGKey(0), cfg)
    jlocal = jax.tree.map(
        lambda l: l + 0.01 * jax.random.normal(jax.random.PRNGKey(1),
                                               l.shape), jg)
    g, local = to_torch(jg), to_torch(jlocal)
    theta_hat, res = tlr.lowrank_upload(local, g, rank=4,
                                        starts=_jstarts(g, 4))
    _check_residual_identity(theta_hat, local, g, res)
    jth, _ = jlr.lowrank_upload(jlocal, jg, rank=4)
    for (p, a), (_, b) in zip(leaf_paths(params_to_numpy(theta_hat)),
                              leaf_paths(jax.tree.map(_np, jth))):
        np.testing.assert_allclose(a, b, err_msg=p, **PARITY)
    # the default (no generator, no starts) is the fixed start everywhere
    th0, _ = tlr.lowrank_upload(local, g, rank=4)
    th1, _ = tlr.lowrank_upload(local, g, rank=4)
    for (_, a), (_, b) in zip(leaf_paths(th0), leaf_paths(th1)):
        assert torch.equal(a, b)


def test_error_feedback_reduces_truncation_bias():
    """EF makes the compressor's cumulative sent messages track the true
    cumulative delta."""
    g = {"w": torch.zeros(48, 48)}
    local = {"w": _t(jax.random.normal(jax.random.PRNGKey(3), (48, 48)))}
    true_delta = local["w"] - g["w"]
    rounds, rank = 12, 8
    sent_ef = torch.zeros_like(true_delta)
    res = None
    for _ in range(rounds):
        th, res = tlr.lowrank_upload(local, g, rank=rank, residual=res)
        sent_ef += th["w"] - g["w"]
    err_ef = float(torch.linalg.norm(sent_ef - rounds * true_delta))
    th0, _ = tlr.lowrank_upload(local, g, rank=rank)
    err_nef = float(torch.linalg.norm(
        rounds * (th0["w"] - g["w"]) - rounds * true_delta))
    assert err_ef < err_nef * 0.8


def test_error_feedback_matches_reference():
    """Three EF rounds with the fixed start: the residual carried and the
    reconstruction, against the reference's."""
    jg = {"w": jnp.zeros((48, 40)), "b": jnp.zeros((40,))}
    jlocal = jax.tree.map(
        lambda l: jax.random.normal(jax.random.PRNGKey(3), l.shape), jg)
    g, local = to_torch(jg), to_torch(jlocal)
    jres = res = None
    for _ in range(3):
        jth, jres = jlr.lowrank_upload(jlocal, jg, rank=4, residual=jres)
        th, res = tlr.lowrank_upload(local, g, rank=4, residual=res,
                                     starts=_jstarts(g, 4))
    for got, want in ((th, jth), (res, jres)):
        for (p, a), (_, b) in zip(leaf_paths(params_to_numpy(got)),
                                  leaf_paths(jax.tree.map(_np, want))):
            np.testing.assert_allclose(a, b, err_msg=p, **PARITY)


def test_bytes_model():
    cfg = jcnn.VGGConfig()
    jg = jcnn.init_params(jax.random.PRNGKey(0), cfg)
    g = to_torch(jg)
    full = sum(l.numel() * l.element_size() for _, l in leaf_paths(g))
    lr = tlr.lowrank_bytes(g, rank=8)
    assert lr < 0.3 * full  # big compression on conv/fc matrices
    assert lr > 0           # and the dense small leaves still counted
    for rank in (1, 8, 64):
        assert tlr.lowrank_bytes(g, rank) == jlr.lowrank_bytes(jg, rank)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_quantized_bytes_per_param_matches_reference(bits):
    assert tcompress.quantized_bytes_per_param(bits) == \
        jcompress.quantized_bytes_per_param(bits)
