"""The dry-run's placement and programs against the reference: the
data-axis half of ``auto_spec`` / ``param_specs`` (with every variant's
overrides), ``batch_specs`` and ``to_named`` of
``repro_torch.launch.sharding``, the shape-only meshes of
``repro_torch.launch.mesh``, ``repro_torch.launch.shapes``'s programs,
``repro_torch.launch.variants`` and ``model_flops_for``, each equal to the
reference's exactly, for every arch and shape."""
import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as jget
from repro.launch import roofline as jroof
from repro.launch import sharding as jsh
from repro.launch import shapes as jshapes
from repro.launch import variants as jvar
from repro_torch.configs import get_config as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.launch import sharding as tsh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import variants as tvar
from repro_torch.models.config import reference_fields


class FakeMesh:
    """Shape-only mesh stand-in, as ``tests/test_sharding.py`` has it."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "32x8": tmesh.make_production_mesh(),
    "2x32x8": tmesh.make_production_mesh(multi_pod=True),
}
SHAPES = tuple(jshapes.SHAPES)


def _tuples(spec_tree):
    """The reference's PartitionSpec tree as the port's tuples."""
    return jax.tree.map(tuple, spec_tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _programs(arch):
    """{shape: (reference Program, port Program)} of one arch."""
    out = {}
    for name, jspec in jshapes.SHAPES.items():
        tspec = tshapes.SHAPES[name]
        out[name] = (
            jshapes.build_program(jshapes.adapt_config(jget(arch), jspec),
                                  jspec),
            tshapes.build_program(tshapes.adapt_config(tget(arch), tspec),
                                  tspec))
    return out


# ----------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------
def test_production_and_host_meshes_are_shape_only():
    m = tmesh.make_production_mesh()
    assert m.shape == {"data": 32, "model": 8}
    assert m.axis_names == ("data", "model")
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 32, "model": 8}
    assert tmesh.data_axes(m) == ("data",)
    assert tmesh.data_axes(mp) == ("pod", "data")
    h = tmesh.make_host_mesh(4, 2)
    assert h.shape == {"data": 4, "model": 2}
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_data_axes_equal_reference(mesh):
    from repro.launch.mesh import data_axes
    assert tmesh.data_axes(MESHES[mesh]) == data_axes(MESHES[mesh])


# ----------------------------------------------------------------------
# auto_spec on hand-picked shapes (tests/test_sharding.py's cases)
# ----------------------------------------------------------------------
AUTO_CASES = [((5120, 13824), False), ((48, 5120, 13824), True),
              ((1600, 25), False), ((7, 9), False), ((5120, 8192), False),
              ((3072, 16), False), ((64, 2048, 151936), True),
              ((256, 16, 1, 1), False), ((8, 8), False)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model_only", [False, True])
def test_auto_spec_equals_reference(mesh, model_only):
    m = MESHES[mesh]
    for shape, skip in AUTO_CASES:
        got = tsh.auto_spec(shape, m, skip_leading=skip, model_only=model_only)
        want = jsh.auto_spec(shape, m, skip_leading=skip,
                             model_only=model_only)
        assert got == tuple(want), (shape, skip)


def test_auto_spec_multipod_uses_pod_axis():
    assert tsh.auto_spec((5120, 8192), MESHES["2x16x16"]) == \
        (("pod", "data"), "model")
    assert tsh.auto_spec((5120, 13824), MESHES["16x16"]) == ("data", "model")


# ----------------------------------------------------------------------
# param_specs / batch_specs of every program's arguments
# ----------------------------------------------------------------------
def _variant_overrides(name, arch, mesh):
    """Both packages' overrides of variant ``name`` (None: baseline)."""
    if name is None:
        return None, None
    daxes = tmesh.data_axes(mesh)
    _, jov = jvar.apply_variant(name, jget(arch), daxes)
    _, tov = tvar.apply_variant(name, tget(arch), daxes)
    return jov, tov


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_of_every_program_equal_reference(arch, mesh):
    """Every shape's params, batches and caches, without and with every
    variant's overrides: the port's specs are ``tuple()`` of the
    reference's, exactly."""
    m = MESHES[mesh]
    for shape, (jp, tp) in _programs(arch).items():
        assert jp.arg_kinds == tp.arg_kinds
        client_leading = tp.flcfg is not None
        for variant in (None, *tvar.VARIANTS):
            jov, tov = _variant_overrides(variant, arch, m)
            for ja, ta, kind in zip(jp.args, tp.args, tp.arg_kinds):
                if kind in ("params", "cache"):
                    got = tsh.param_specs(ta, m, overrides=tov)
                    want = _tuples(jsh.param_specs(ja, m, overrides=jov))
                elif kind == "batch":
                    if variant is not None:
                        continue        # no override reaches a batch
                    got = tsh.batch_specs(ta, m,
                                          client_leading=client_leading)
                    want = _tuples(jsh.batch_specs(
                        ja, m, client_leading=client_leading))
                else:
                    continue
                assert got == want, (shape, variant, kind)


def test_param_specs_overrides_first_match_wins():
    m = MESHES["16x16"]
    ps = tshapes.params_struct(tget("qwen3-1.7b"))
    specs = tsh.param_specs(ps, m, overrides={r"embed/tok": (None, "model"),
                                              r"embed": ("model", None)})
    assert specs["embed"]["tok"] == (None, "model")
    assert specs["blocks"]["mlp"]["w_up"] == (None, "data", "model")
    assert specs["final"]["norm"] == ()


def test_batch_specs_fall_back_to_replication():
    m = MESHES["32x8"]
    b = {"tokens": torch.empty((8, 32, 4096), device="meta")}
    assert tsh.batch_specs(b, m, client_leading=True)["tokens"] == \
        (None, "data", None)
    one = {"tokens": torch.empty((1, 1), device="meta")}
    assert tsh.batch_specs(one, m)["tokens"] == ()


def test_fl_param_specs_unchanged_by_the_data_half():
    """The FL engine's specs stay 'model'-only (no data axis) on a mesh
    that also has data axes."""
    ps = tshapes.params_struct(tget("qwen3-1.7b").reduced())
    m = tmesh.ShapeMesh({"clients": 2, "model": 2})
    specs = tsh.fl_param_specs(ps, m)
    for leaf in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tuple)):
        assert all(a in (None, "model") for a in leaf)


# ----------------------------------------------------------------------
# to_named: torch.distributed.tensor placements
# ----------------------------------------------------------------------
def test_to_named_gives_one_placement_a_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x32x8"]
    ps = tshapes.params_struct(tget("qwen3-1.7b"))
    specs = tsh.param_specs(ps, m)
    named = tsh.to_named(specs, m)
    # w_up (L, d, f): d -> ('pod', 'data'), f -> 'model'
    assert specs["blocks"]["mlp"]["w_up"] == (None, ("pod", "data"), "model")
    assert named["blocks"]["mlp"]["w_up"] == (Shard(1), Shard(1), Shard(2))
    assert named["final"]["norm"] == (Replicate(),) * 3
    assert named["embed"]["tok"] == (Shard(1), Shard(1), Shard(0))
    # the structure is the spec tree's
    assert jax.tree.structure(named, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.structure(specs, is_leaf=lambda x: isinstance(x, tuple))


# ----------------------------------------------------------------------
# programs: shapes, dtypes, devices
# ----------------------------------------------------------------------
def _leaf_shapes(tree):
    """{path: (shape, dtype name)} of a tree's array leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "meta", path
            out[jax.tree_util.keystr(path)] = (
                tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            out[jax.tree_util.keystr(path)] = (tuple(leaf.shape),
                                               str(leaf.dtype))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_program_arguments_equal_reference(arch, shape):
    """params, batch and cache leaves: the reference's shapes and dtypes
    (``jax.eval_shape``), on ``meta``; the same kinds and adapted config.
    The cache's ``pos`` is the port's Python int (the step at the
    context's last position); the train program's last argument is the
    port's ``uniform`` in place of the reference's key."""
    jp, tp = _programs(arch)[shape]
    assert jp.arg_kinds == tp.arg_kinds
    assert dataclasses.asdict(jshapes.adapt_config(
        jget(arch), jshapes.SHAPES[shape])) == reference_fields(
        tshapes.adapt_config(tget(arch), tshapes.SHAPES[shape]))
    for ja, ta, kind in zip(jp.args, tp.args, tp.arg_kinds):
        if callable(ta):
            assert ta is tshapes.meta_uniform and ja.shape == (2,)
            continue
        if kind == "cache":
            assert ta["pos"] == tshapes.SHAPES[shape].seq - 1
            ja = {k: v for k, v in ja.items() if k != "pos"}
            ta = {k: v for k, v in ta.items() if k != "pos"}
        assert _leaf_shapes(ta) == _leaf_shapes(ja), kind


def test_params_struct_allocates_and_draws_nothing():
    """llama4-maverick-400b-a17b's 1.57 TB of bf16 on meta, in seconds."""
    ps = tshapes.params_struct(tget("llama4-maverick-400b-a17b"))
    leaves = jax.tree.leaves(ps)
    assert all(l.device.type == "meta" for l in leaves)
    nbytes = sum(l.numel() * l.element_size() for l in leaves)
    ref = jshapes.params_struct(jget("llama4-maverick-400b-a17b"))
    assert nbytes == sum(l.size * l.dtype.itemsize
                         for l in jax.tree.leaves(ref))
    assert nbytes > 1.5e12


def test_init_params_draws_unchanged_off_meta():
    """The meta route leaves every other caller's draws as they were."""
    cfg = tget("qwen3-1.7b").reduced()
    from repro_torch.models import transformer as tf
    a = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    g = torch.Generator().manual_seed(3)
    first = (torch.randn((cfg.vocab_size, cfg.d_model), generator=g)
             * 0.02).to(a["embed"]["tok"].dtype)
    assert torch.equal(a["embed"]["tok"], first)


# ----------------------------------------------------------------------
# variants and model_flops_for
# ----------------------------------------------------------------------
def test_variant_names_and_hypotheses_equal_reference():
    assert tuple(tvar.VARIANTS) == tuple(jvar.VARIANTS)
    assert len(tvar.VARIANTS) == 13
    for name, v in tvar.VARIANTS.items():
        assert v.hypothesis == jvar.VARIANTS[name].hypothesis


@pytest.mark.parametrize("variant", tuple(jvar.VARIANTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_apply_variant_equals_reference(variant, arch):
    for daxes in (("data",), ("pod", "data")):
        jcfg, jov = jvar.apply_variant(variant, jget(arch), daxes)
        tcfg, tov = tvar.apply_variant(variant, tget(arch), daxes)
        assert reference_fields(tcfg) == dataclasses.asdict(jcfg)
        if jov is None:
            assert tov is None
        else:
            assert tov == {k: tuple(v) for k, v in jov.items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_equals_reference(arch, shape):
    jcfg = jshapes.adapt_config(jget(arch), jshapes.SHAPES[shape])
    tcfg = tshapes.adapt_config(tget(arch), tshapes.SHAPES[shape])
    got = troof.model_flops_for(tcfg, tshapes.SHAPES[shape],
                                tshapes.FL_TRAIN)
    assert got == jroof.model_flops_for(jcfg, jshapes.SHAPES[shape],
                                        jshapes.FL_TRAIN)
    assert got > 0
