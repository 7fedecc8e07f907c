"""The port's client mesh against the reference, in one process: the tier
byte accounting, ``local_rows``, ``ClientShards.with_affinity``, the
``FLConfig`` mesh checks and ``make_client_mesh``'s errors (the
reference's messages), the run header's ``mesh`` / ``agg`` /
``shard_samples``, the additive halves of the aggregation
(``stacked_psum_parts``, FedADP's), the pack and unpack of the round's one
cross-rank sum, and the sharded round on a mesh of one rank. The spawned
worlds of 2 and 4 ranks are ``tests/test_torch_mesh_ranks.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data as jdata  # noqa: E402
from repro.core import agg_tier_bytes as jtier  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import fedadp as jfedadp  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro.federated.sampling import local_rows as jlocal_rows  # noqa: E402
from repro.launch.mesh import (CLIENT_AXIS as JAXIS,  # noqa: E402
                               make_client_mesh as jmesh, shard_map_norep)
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import fedadp as tfedadp  # noqa: E402
from repro_torch.core.units import UnitMap as TUnitMap  # noqa: E402
from repro_torch.data import ClientShards  # noqa: E402
from repro_torch.federated import FLConfig as TFLConfig  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.sampling import local_rows  # noqa: E402
from repro_torch.federated.strategies import (FLStrategy,  # noqa: E402
                                              register_strategy,
                                              unregister_strategy)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro.core.units import UnitMap as JUnitMap  # noqa: E402
from repro.federated.strategies import (  # noqa: E402
    FLStrategy as JFLStrategy, register_strategy as jregister,
    unregister_strategy as junregister)

PARAM_TOL = 2e-5   # tests/test_shard_engine.py:25 (EQUIV_TOL)
VGG_PAYLOAD = 4_709_706 * 4


# ----------------------------------------------------------------------
# tier bytes, local_rows
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 8, 12, 16])
def test_agg_tier_bytes_match_reference(d):
    for gs in [0] + [g for g in range(1, d + 1) if d % g == 0]:
        for p in (VGG_PAYLOAD, 1234.5):
            assert tcomm.agg_tier_bytes(p, d, gs) == jtier(p, d, gs)


def test_agg_tier_bytes_refuse_a_non_divisor_like_the_reference():
    with pytest.raises(ValueError) as want:
        jtier(100.0, 8, 3)
    with pytest.raises(ValueError) as got:
        tcomm.agg_tier_bytes(100.0, 8, 3)
    assert str(got.value) == str(want.value)


def test_agg_tier_bytes_of_phase_18():
    """The values chip_smoke.py's phase 18 asserts at full-width VGG-9."""
    flat = tcomm.agg_tier_bytes(VGG_PAYLOAD, 4)
    two = tcomm.agg_tier_bytes(VGG_PAYLOAD, 4, 2)
    assert (flat["agg_intra_bytes"], flat["agg_cross_bytes"],
            flat["agg_cross_bytes_per_host"]) == (0.0, 56_516_472.0,
                                                  113_032_944.0)
    assert (two["agg_intra_bytes"], two["agg_cross_bytes"],
            two["agg_cross_bytes_per_host"]) == (37_677_648.0,) * 3


@pytest.mark.parametrize("d", [1, 2, 4])
def test_local_rows_are_the_ranks_contiguous_blocks(d):
    arr = torch.arange(24).reshape(8, 3)
    blocks = [local_rows(arr, r, 8 // d) for r in range(d)]
    assert torch.equal(torch.cat(blocks), arr)
    for r, blk in enumerate(blocks):
        assert torch.equal(blk, arr[r * 8 // d:(r + 1) * 8 // d])


def test_local_rows_match_reference_on_one_device():
    arr = np.arange(24, dtype=np.float32).reshape(8, 3)
    m = jmesh(1)
    from jax.sharding import PartitionSpec as P
    got = shard_map_norep(lambda a: jlocal_rows(a, JAXIS, 8), m,
                          in_specs=P(), out_specs=P())(jnp.asarray(arr))
    np.testing.assert_array_equal(
        np.asarray(got), local_rows(torch.from_numpy(arr), 0, 8).numpy())


# ----------------------------------------------------------------------
# ClientShards.with_affinity / place
# ----------------------------------------------------------------------
def _ragged(n_clients=8, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 6, size=n_clients)
    total = int(sizes.sum())
    xs = rng.standard_normal((total, 4)).astype(np.float32)
    ys = rng.integers(0, 3, size=total).astype(np.int32)
    parts = np.split(rng.permutation(total), np.cumsum(sizes)[:-1])
    return xs, ys, parts


@pytest.mark.parametrize("groups", [2, 4, 8])
def test_with_affinity_matches_reference(groups):
    xs, ys, parts = _ragged()
    jaff = jdata.ClientShards.from_federated(
        jdata.FederatedData(xs, ys, parts)).with_affinity(groups)
    shards = ClientShards.from_federated(tdata.FederatedData(xs, ys, parts))
    aff = shards.with_affinity(groups)
    np.testing.assert_array_equal(aff.part_idx.numpy(),
                                  np.asarray(jaff.part_idx))
    np.testing.assert_array_equal(aff.xs.numpy(), np.asarray(jaff.xs))
    np.testing.assert_array_equal(aff.ys.numpy(), np.asarray(jaff.ys))
    assert (aff.group_block, aff.num_groups) == (jaff.group_block,
                                                 jaff.num_groups)
    assert aff.with_affinity(groups) is aff            # idempotent
    # gather's values are unchanged by the re-layout
    g = torch.Generator().manual_seed(groups)
    clients = torch.randperm(8, generator=g)[:4]
    j = torch.randint(0, 2 ** 20, (4, 6), generator=g) \
        % shards.part_sizes[clients].long()[:, None]
    for key in ("images", "labels"):
        assert torch.equal(aff.gather(clients, j)[key],
                           shards.gather(clients, j)[key])


def test_with_affinity_refuses_like_the_reference():
    xs, ys, parts = _ragged()
    with pytest.raises(ValueError) as want:
        jdata.ClientShards.from_federated(
            jdata.FederatedData(xs, ys, parts)).with_affinity(3)
    with pytest.raises(ValueError) as got:
        ClientShards.from_federated(
            tdata.FederatedData(xs, ys, parts)).with_affinity(3)
    assert str(got.value) == str(want.value)


def test_place_keeps_the_ranks_block_only():
    """A mesh of one rank places everything; the sample-sharded block of
    rank 1 of a 2-rank mesh (a mesh object without a process group: no
    collective runs here) holds half the rows and gathers its group's
    clients' samples from them."""
    xs, ys, parts = _ragged()
    shards = ClientShards.from_federated(tdata.FederatedData(xs, ys, parts))
    one = tmesh.make_client_mesh(1, device="cpu")
    assert shards.place(one, shard_samples=True).bytes_per_device() == \
        shards.bytes_per_device()
    aff = shards.with_affinity(2)
    blk = shards.place(tmesh.ClientMesh(2, 1, "cpu", None),
                       shard_samples=True)
    assert blk.sample_base == aff.group_block
    assert blk.xs.shape[0] == aff.group_block
    clients = torch.tensor([5, 4, 7])
    j = torch.zeros((3, 2), dtype=torch.long)
    for key in ("images", "labels"):
        assert torch.equal(blk.gather(clients, j)[key],
                           aff.gather(clients, j)[key])
    assert blk.is_block and not aff.is_block
    with pytest.raises(ValueError, match="block"):
        blk.with_affinity(4)
    # placing a block again keeps it; another rank's block is refused
    assert blk.place(tmesh.ClientMesh(2, 1, "cpu", None), True) \
        .sample_base == blk.sample_base
    with pytest.raises(ValueError, match="not rank 0's"):
        blk.place(tmesh.ClientMesh(2, 0, "cpu", None), True)


# ----------------------------------------------------------------------
# FLConfig checks, make_client_mesh errors
# ----------------------------------------------------------------------
def _base(cls, **kw):
    return cls(algo="fedavg", num_clients=8, clients_per_round=4, top_n=2,
               mode="vmap", batch_per_client=2, **kw)


def _same_error(jfn, tfn):
    """The same exception type and message (a message naming a module
    names the port's own)."""
    with pytest.raises(Exception) as want:
        jfn()
    with pytest.raises(Exception) as got:
        tfn()
    assert type(got.value) is type(want.value)
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)


@pytest.mark.parametrize("kw", [dict(agg_group_size=2),
                                dict(shard_samples=True)],
                         ids=["agg_group_size", "shard_samples"])
def test_mesh_knobs_off_the_mesh_raise_the_references_errors(kw):
    _same_error(lambda: _base(JFLConfig, **kw), lambda: _base(TFLConfig, **kw))


def test_mesh_config_errors_are_the_references():
    jm, tm = jmesh(1), tmesh.make_client_mesh(1, device="cpu")
    # a group larger than the mesh, a scan round on a mesh
    _same_error(lambda: _base(JFLConfig, mesh=jm, agg_group_size=2),
                lambda: _base(TFLConfig, mesh=tm, agg_group_size=2))
    _same_error(lambda: dataclasses.replace(_base(JFLConfig, mesh=jm),
                                            mode="scan"),
                lambda: dataclasses.replace(_base(TFLConfig, mesh=tm),
                                            mode="scan"))

    # a strategy that declares supports_mesh=False
    @jregister("nomesh_test")
    class JNoMesh(JFLStrategy):
        supports_mesh = False

    @register_strategy("nomesh_test")
    class TNoMesh(FLStrategy):
        supports_mesh = False

    try:
        _same_error(lambda: JFLConfig(algo="nomesh_test", num_clients=8,
                                      clients_per_round=4, top_n=2,
                                      mesh=jm),
                    lambda: TFLConfig(algo="nomesh_test", num_clients=8,
                                      clients_per_round=4, top_n=2,
                                      mesh=tm))
    finally:
        junregister("nomesh_test")
        unregister_strategy("nomesh_test")


def test_mesh_config_errors_at_two_ranks():
    """K and N that do not divide over 2 ranks (the reference needs 2 JAX
    devices for these; the messages are its own)."""
    m2 = tmesh.ClientMesh(2, 0, "cpu", None)
    with pytest.raises(AssertionError, match="K=5 must divide over 2"):
        TFLConfig(algo="fedavg", num_clients=8, clients_per_round=5,
                  top_n=2, mesh=m2)
    with pytest.raises(ValueError, match="divisible"):
        TFLConfig(algo="fedavg", num_clients=9, clients_per_round=4,
                  top_n=2, mesh=m2, shard_samples=True)
    with pytest.raises(ValueError, match=r"must be in \[1, 2\]"):
        TFLConfig(algo="fedavg", num_clients=8, clients_per_round=4,
                  top_n=2, mesh=m2, agg_group_size=3)
    fl = TFLConfig(algo="fedavg", num_clients=8, clients_per_round=4,
                   top_n=2, mesh=m2, agg_group_size=1, shard_samples=True)
    assert fl.agg_group_size == 1 and fl.shard_samples


def test_make_client_mesh_errors():
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        tmesh.make_client_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="asked for 0 devices"):
        tmesh.make_client_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="process"):
        tmesh.make_client_mesh(processes=2, device="cpu")
    with pytest.raises(ValueError, match="asked for 4 devices, have 1"):
        tmesh.make_client_mesh(4, model=2, device="cpu")
    with pytest.raises(ValueError, match="model=2 must divide"):
        tmesh.make_client_mesh(model=2, device="cpu")
    m = tmesh.make_client_mesh(device="cpu")
    assert (m.size, m.rank, m.backend, m.stage) == (1, 0, None, False)
    assert tmesh.client_mesh_size(m) == 1 and tmesh.model_mesh_size(m) == 1
    assert m.shape == dict(jmesh(1).shape)
    with pytest.raises(ValueError, match="'clients' axis"):
        tmesh.client_mesh_size(type("M", (), {"axis_names": ("data",)})())


def test_a_mesh_of_one_has_identity_collectives():
    m = tmesh.make_client_mesh(1, device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(m.all_gather_rows(x), x)
    assert torch.equal(m.all_reduce_flat(x.clone()), x)
    assert torch.equal(m.ring_shift(x, 1), x)
    assert torch.equal(tagg.hierarchical_psum({"a": x}, m, 1)["a"], x)
    counts = m.counts()
    assert counts["all_gather_rows"] == (1, 24)
    assert counts["staged"] == (0, 0, 0.0)


def test_pack_unpack_round_trip_keeps_shapes_and_dtypes():
    tree = {"x": {"b": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                  "a": torch.tensor(2.5)},
            "h": {"c": torch.ones(4, dtype=torch.float16)}, "e": {}}
    buf, layout = tagg.pack(tree)
    assert buf.dtype == torch.float32 and buf.numel() == 11
    back = tagg.unpack(buf, layout)
    assert back["e"] == {}
    for x, y in ((back["x"]["a"], tree["x"]["a"]),
                 (back["x"]["b"], tree["x"]["b"]),
                 (back["h"]["c"], tree["h"]["c"])):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ----------------------------------------------------------------------
# the run header
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(agg_group_size=1),
                                dict(shard_samples=True)],
                         ids=["flat", "gs1", "shard"])
def test_run_meta_mesh_fields_match_reference(kw):
    jm, tm = jmesh(1), tmesh.make_client_mesh(1, device="cpu")
    p = {"l": {"w": np.zeros((3, 2), np.float32)}}
    meta = dict(driver="scan", seed=0, sampler="device", start_round=0,
                rounds=2, run_id="r")
    want = jserver._run_meta(_base(JFLConfig, mesh=jm, **kw),
                             umap=JUnitMap.build(jax.tree.map(jnp.asarray,
                                                              p)), **meta)
    got = tserver._run_meta(_base(TFLConfig, mesh=tm, **kw),
                            umap=TUnitMap.build(params_from_numpy(p, "cpu")),
                            **meta)
    for key in ("mesh", "agg", "shard_samples"):
        assert got[key] == want[key], key
    assert got["mesh"] == {"clients": 1}
    off = tserver._run_meta(_base(TFLConfig),
                            umap=TUnitMap.build(params_from_numpy(p, "cpu")),
                            **meta)
    assert (off["mesh"], off["agg"], off["shard_samples"]) == \
        (None, None, False)


# ----------------------------------------------------------------------
# the additive halves of the aggregation
# ----------------------------------------------------------------------
def _stacked(seed=0, k=5):
    rng = np.random.default_rng(seed)
    g = {"conv": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
         "blocks": {"w": rng.standard_normal((3, 4, 6)).astype(np.float32)}}
    st = jax.tree.map(lambda l: (l[None] + 0.1 * rng.standard_normal(
        (k,) + l.shape)).astype(np.float32), g)
    return g, st


def test_stacked_psum_parts_match_reference():
    g, st = _stacked()
    umap = TUnitMap.build(params_from_numpy(g, "cpu"))
    rng = np.random.default_rng(1)
    sel = (rng.random((5, umap.num_units)) < 0.5).astype(np.float32)
    sizes = np.arange(1, 6, dtype=np.float32)
    jparts, jden = jagg.stacked_psum_parts(
        jax.tree.map(jnp.asarray, st),
        JUnitMap.build(jax.tree.map(jnp.asarray, g)), jnp.asarray(sel),
        jnp.asarray(sizes))
    tparts, tden = tagg.stacked_psum_parts(
        params_from_numpy(st, "cpu"), umap, torch.from_numpy(sel),
        torch.from_numpy(sizes))
    np.testing.assert_allclose(tden.numpy(), np.asarray(jden), rtol=1e-6)
    for x, y in zip(jax.tree.leaves(params_to_numpy(tparts)),
                    jax.tree.leaves(jparts)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-5)
    # parts + finalize over two halves of the clients = aggregate_stacked
    tst = params_from_numpy(st, "cpu")
    halves = [tagg.stacked_psum_parts(
        {k_: {n_: v[rows] for n_, v in sub.items()} for k_, sub in
         tst.items()}, umap, torch.from_numpy(sel[rows]),
        torch.from_numpy(sizes[rows])) for rows in (slice(0, 2),
                                                    slice(2, 5))]
    parts = jax.tree.map(lambda a, b: a + b, halves[0][0], halves[1][0])
    fb = params_from_numpy(g, "cpu")
    got = tagg.stacked_psum_finalize(parts, halves[0][1] + halves[1][1],
                                     umap, fb, fb)
    want = tagg.aggregate_stacked(tst, umap, torch.from_numpy(sel),
                                  torch.from_numpy(sizes), fallback=fb)
    for x, y in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(params_to_numpy(want))):
        np.testing.assert_allclose(x, y, atol=1e-6)


def test_fedadp_psum_halves_match_reference():
    g, st = _stacked(2)
    sizes = np.array([3, 1, 4, 1, 5], np.float32)
    jn, jd = jfedadp.fedadp_psum_parts(jax.tree.map(jnp.asarray, st),
                                       jax.tree.map(jnp.asarray, g),
                                       jnp.asarray(sizes), 0.5)
    tn, td = tfedadp.fedadp_psum_parts(params_from_numpy(st, "cpu"),
                                       params_from_numpy(g, "cpu"),
                                       torch.from_numpy(sizes), 0.5)
    for x, y in zip(jax.tree.leaves(params_to_numpy(tn)) +
                    jax.tree.leaves(params_to_numpy(td)),
                    jax.tree.leaves(jn) + jax.tree.leaves(jd)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-5)
    jfin = jfedadp.fedadp_psum_finalize(jn, jd, jax.tree.map(jnp.asarray, g))
    tfin = tfedadp.fedadp_psum_finalize(tn, td, params_from_numpy(g, "cpu"))
    for x, y in zip(jax.tree.leaves(params_to_numpy(tfin)),
                    jax.tree.leaves(jfin)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-5)
    # the halves over all clients = the one-device aggregation
    one = tfedadp.aggregate_fedadp(params_from_numpy(st, "cpu"),
                                   params_from_numpy(g, "cpu"),
                                   torch.from_numpy(sizes), 0.5)
    for x, y in zip(jax.tree.leaves(params_to_numpy(tfin)),
                    jax.tree.leaves(params_to_numpy(one))):
        np.testing.assert_allclose(x, y, atol=1e-6)


def test_state_specs_split_client_rows_and_replicate_globals():
    from repro_torch.federated import make_strategy
    fl = _base(TFLConfig)
    params = {"w": torch.zeros(4, 6), "b": torch.zeros(6)}
    st = {"client": {"residual": {"w": torch.zeros(5, 4, 6),
                                  "b": torch.zeros(5, 6)}},
          "global": {"ttl": torch.zeros(3)}}
    strategy = make_strategy(fl)
    # off a 2-D mesh every entry is replicated (every client entry's rows
    # are split by client coordinate in the round all the same)
    assert strategy.state_specs(params, st, None) == {
        "client": {"residual": {"w": (), "b": ()}}, "global": {"ttl": ()}}
    # on a 2-D mesh the param-shaped client entry takes the params' specs
    grid = type("Grid", (), {"axis_names": ("clients", "model"),
                             "shape": {"clients": 2, "model": 2}})()
    assert strategy.state_specs(params, st, grid) == {
        "client": {"residual": {"w": (None, "model"), "b": ()}},
        "global": {"ttl": ()}}


# ----------------------------------------------------------------------
# the sharded round on a mesh of one rank
# ----------------------------------------------------------------------
def test_round_comm_and_aggregate_on_a_mesh_of_one():
    g, st = _stacked(3)
    p = params_from_numpy(g, "cpu")
    umap = TUnitMap.build(p)
    sel = torch.ones(5, umap.num_units)
    sizes = torch.arange(1.0, 6.0)
    m = tmesh.make_client_mesh(1, device="cpu")
    assert tcomm.round_comm(sel, umap, mesh=m).keys() == \
        tcomm.round_comm(sel, umap).keys()
    for key, v in tcomm.round_comm(sel, umap, mesh=m).items():
        assert float(v) == float(tcomm.round_comm(sel, umap)[key]), key
    sp = params_from_numpy(st, "cpu")
    a = tagg.aggregate_stacked(sp, umap, sel, sizes, fallback=p, mesh=m)
    b = tagg.aggregate_stacked(sp, umap, sel, sizes, fallback=p)
    for x, y in zip(jax.tree.leaves(params_to_numpy(a)),
                    jax.tree.leaves(params_to_numpy(b))):
        np.testing.assert_allclose(x, y, atol=1e-6)
