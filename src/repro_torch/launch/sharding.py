"""Placement specs, port of ``repro.launch.sharding``: the divisibility-
driven policy of the dry-run (:mod:`repro_torch.launch.dryrun`) and the FL
engine's 'model'-axis placement (FSDP of the params, the frozen base and
the per-client stores over the 2-D ``('clients', 'model')`` mesh,
:func:`repro_torch.launch.mesh.make_client_mesh` with ``model`` M > 1).

A spec is a plain tuple with one entry a dim: an axis name, a tuple of
axis names (``("pod", "data")``) or None; ``()`` for a replicated leaf. It
equals ``tuple()`` of the reference's ``PartitionSpec``. :func:`to_named`
turns a spec tree into ``torch.distributed.tensor`` placements, one a mesh
axis, for a caller that holds a real ``DeviceMesh`` of the same shape.

The dry-run policy (:func:`auto_spec`, :func:`param_specs`): for every
parameter or cache leaf, its largest divisible dim → 'model' (tensor
parallel), the next largest → the data/FSDP axis product ('data', or
('pod', 'data') on the multi-pod mesh), everything else replicated. The
leading depth dim of a stacked top-level key is never cut, and 1-D leaves
are replicated. A dim the axis does not divide falls back to the next, or
to replication. ``overrides`` pins specs by path regex, first match wins.

The FL engine's placement (:func:`fl_param_specs`): every parameter leaf
is cut 1/M along its largest dim that M divides; the leading unit axis of
every stacked key (``core.units.DEFAULT_STACKED_KEYS``, ``experts``
included) is never cut, and a leaf with no such dim (every 1-D leaf) stays
whole on every rank. :func:`tree_all_gather` and :func:`tree_shard_slice`
move leaves between the rank's shards and whole values: one all-gather
over the rank's model row, and a local slice, both exact. On the 1-D mesh
(or without one) every spec is ``()`` and every leaf whole.
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional

import torch

from repro_torch.core.units import (DEFAULT_STACKED_KEYS, tree_leaves,
                                    tree_map, tree_unflatten)
from repro_torch.launch.mesh import MODEL_AXIS, data_axes, model_mesh_size

Pytree = Any

STACKED_TOPKEYS = ("blocks", "enc_blocks", "dec_blocks")
# every leaf's bytes start on this boundary in the gather's byte buffer, so
# that each piece views back into its dtype
_ALIGN = 16


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(int(mesh.shape[a]) for a in axis)
    return int(mesh.shape[axis])


def data_axis_entry(daxes: tuple[str, ...]):
    """The data/FSDP axis entry of a spec for the data axes ``daxes``: one
    name, or the tuple of them on a mesh with several ('pod', 'data')."""
    return daxes if len(daxes) > 1 else daxes[0]


def _data_axis(mesh):
    return data_axis_entry(data_axes(mesh))


def auto_spec(shape: tuple[int, ...], mesh, *, skip_leading: bool = False,
              model_axis: str = MODEL_AXIS,
              model_only: bool = False) -> tuple:
    """The spec of one array shape: its largest dim (the later of equal
    ones) that the mesh's ``model_axis`` size divides → ``model_axis``,
    then, unless ``model_only``, the largest of the rest that the data
    axes' product divides → those axes; the leading dim skipped with
    ``skip_leading``; every other dim replicated. ``model_only`` is the FL
    round engine's policy: a ('clients', 'model') mesh never cuts a
    parameter leaf over 'clients'."""
    dims = range(1 if skip_leading else 0, len(shape))
    spec: list = [None] * len(shape)

    def pick(axis, exclude: Optional[int]) -> Optional[int]:
        size = _axis_size(mesh, axis)
        cands = [d for d in dims if d != exclude
                 and shape[d] >= size and shape[d] % size == 0]
        if not cands:
            return None
        return max(cands, key=lambda d: (shape[d], d))

    dm = pick(model_axis, None)
    if dm is not None:
        spec[dm] = model_axis
    if not model_only:
        daxis = _data_axis(mesh)
        dd = pick(daxis, dm)
        if dd is not None:
            spec[dd] = daxis
    return tuple(spec)


def _specs_by_path(tree: Pytree, assign, prefix: str = "") -> Pytree:
    """``assign(path, leaf)`` over a nested dict, the path the reference's
    ``"top/sub/leaf"``."""
    if isinstance(tree, dict):
        return {k: _specs_by_path(v, assign, f"{prefix}{k}/")
                for k, v in tree.items()}
    return assign(prefix.rstrip("/"), tree)


def param_specs(params_shape: Pytree, mesh,
                overrides: Optional[dict[str, tuple]] = None,
                model_only: bool = False,
                stacked_keys: tuple[str, ...] = STACKED_TOPKEYS) -> Pytree:
    """The spec tree of a parameter (or cache) tree; leaves: anything with
    a ``.shape`` (a leaf without one, such as a cache's int ``pos``, is a
    scalar). ``overrides``: ``{path-regex: spec}``, the first match wins.
    Otherwise :func:`auto_spec` of every leaf of two or more dims, its
    leading depth dim skipped under ``stacked_keys``; ``()`` for the rest.
    ``model_only``: see :func:`auto_spec`."""
    overrides = overrides or {}

    def assign(path: str, leaf) -> tuple:
        for pat, spec in overrides.items():
            if re.search(pat, path):
                return tuple(spec)
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) <= 1:
            return ()
        return auto_spec(shape, mesh,
                         skip_leading=path.split("/", 1)[0] in stacked_keys,
                         model_only=model_only)

    return _specs_by_path(params_shape, assign)


def batch_specs(batch_shape: Pytree, mesh, *,
                client_leading: bool = False) -> Pytree:
    """Shard the batch dim over the data axes. Leaves: (K, b, ...) when
    ``client_leading`` (an FL round's batch; the per-client batch dim b is
    cut) or (b, ...) otherwise. A leaf whose b the axes' product does not
    divide (long_500k's batch of 1) is replicated."""
    daxis = _data_axis(mesh)
    dsize = _axis_size(mesh, daxis)
    bdim = 1 if client_leading else 0

    def assign(leaf) -> tuple:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) <= bdim or shape[bdim] % dsize or shape[bdim] < dsize:
            return ()
        spec: list = [None] * len(shape)
        spec[bdim] = daxis
        return tuple(spec)

    return tree_map(assign, batch_shape)


def _placements(spec: tuple, mesh) -> tuple:
    """One ``torch.distributed.tensor`` placement a mesh axis, in the
    mesh's axis order: ``Shard(d)`` where dim d names the axis (alone or
    in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dim = next((d for d, s in enumerate(spec)
                    if s == axis or (isinstance(s, tuple) and axis in s)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def to_named(spec_tree: Pytree, mesh) -> Pytree:
    """The placements of every spec of ``spec_tree``, one a mesh axis:
    ``distribute_tensor(t, device_mesh, to_named(...)[...])`` on a
    ``DeviceMesh`` of ``mesh``'s shape lays a leaf out as the spec says.
    Building them needs no process group."""
    return tree_map(lambda s: _placements(s, mesh), spec_tree)


def fl_param_specs(params_shape: Pytree, mesh,
                   model_axis: str = MODEL_AXIS) -> Pytree:
    """The FL round engine's specs: the 'model' axis only (the 'clients'
    axis carries stacked clients, never parameter blocks), every
    ``DEFAULT_STACKED_KEYS`` depth dim kept whole (the unit axis of the
    Eq. 5 epilogue). All ``()`` on a mesh without a 'model' axis, with
    ``model=1``, or with no mesh."""
    names = getattr(mesh, "axis_names", ())
    if model_axis not in names or int(mesh.shape[model_axis]) <= 1:
        return tree_map(lambda _: (), params_shape)
    return param_specs(params_shape, mesh, model_only=True,
                       stacked_keys=tuple(set(STACKED_TOPKEYS)
                                          | set(DEFAULT_STACKED_KEYS)))


def residual_store_specs(params_shape: Pytree, mesh) -> Pytree:
    """The specs of an ``(N, ...)`` per-client store (EF residuals, any
    client-state entry): the client-id axis whole (any client can be
    sampled onto any rank), the trailing dims the parameter leaf's."""
    return tree_map(lambda s: (None,) + s,
                    fl_param_specs(params_shape, mesh))


def _model_dim(spec: tuple) -> Optional[int]:
    for i, s in enumerate(spec):
        if s == MODEL_AXIS:
            return i
    return None


def shard_shape(shape, spec: tuple, axis_size: int) -> tuple[int, ...]:
    """``shape`` with the spec's 'model' dim cut ``axis_size`` ways."""
    shape = list(shape)
    d = _model_dim(spec)
    if d is not None:
        shape[d] //= axis_size
    return tuple(shape)


def init_residual_store(params: Pytree, num_clients: int,
                        mesh=None) -> Pytree:
    """Per-client error-feedback residual store: every leaf gets a leading
    ``(N,)`` client axis, zero-initialised on the leaf's device **in the
    leaf's own dtype**. Rows for the round's participants are gathered
    before the round and scattered back after: residuals belong to
    clients, not to sampling slots. At N × model size this store is the
    round's largest buffer (942 MB for full-width VGG-9 at N = 50). On a
    2-D ``mesh`` it is created as this rank's shard
    (:func:`residual_store_specs`, 1/M of every sharded leaf): the whole
    store never exists on a rank. On a 1-D mesh every rank holds all N
    rows whole."""
    specs = fl_param_specs(params, mesh)
    m = 1 if mesh is None else model_mesh_size(mesh)
    return tree_map(
        lambda l, s: torch.zeros((num_clients,) + shard_shape(l.shape, s, m),
                                 dtype=l.dtype, device=l.device),
        params, specs)


def tree_all_gather(tree: Pytree, spec_tree: Pytree, mesh,
                    offset: int = 0) -> Pytree:
    """Whole leaves from this rank's 'model'-axis shards: ONE all-gather
    over the rank's model row of one flat byte buffer of every sharded
    leaf (any dtypes), then each leaf's M pieces concatenated along its
    'model' dim. ``spec_tree`` is the :func:`fl_param_specs` tree of the
    unprefixed leaves; ``offset`` shifts every spec dim right (1 for
    client rows, whose leading client axis the spec does not name).
    Leaves without a 'model' dim are returned as they are, so a
    replicated tree makes this a no-op without a collective."""
    leaves, specs = tree_leaves(tree), tree_leaves(spec_tree)
    cut = [(i, d + offset) for i, d in
           enumerate(_model_dim(s) for s in specs) if d is not None]
    if not cut:
        return tree
    pieces, sizes = [], []
    for i, _ in cut:
        b = leaves[i].contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % _ALIGN
        pieces.append(b)
        if pad:
            pieces.append(b.new_zeros(pad))
        sizes.append(b.numel() + pad)
    full = mesh.all_gather_model(torch.cat(pieces))      # (M, bytes)
    out = list(leaves)
    off = 0
    for (i, dim), n in zip(cut, sizes):
        x = leaves[i]
        nb = x.numel() * x.element_size()
        out[i] = torch.cat([row[off:off + nb].view(x.dtype).view(x.shape)
                            for row in full], dim=dim)
        off += n
    return tree_unflatten(tree, iter(out))


def tree_shard_slice(tree: Pytree, spec_tree: Pytree, axis_size: int,
                     index: int, offset: int = 0) -> Pytree:
    """Whole leaves cut down to shard ``index`` of ``axis_size`` along
    each spec's 'model' dim (+ ``offset``), the inverse of
    :func:`tree_all_gather` (same calling convention). Exact: a gather of
    the slices is the tree bit for bit. A shard is a new tensor, so the
    whole leaf can be freed; leaves without a 'model' dim are returned as
    they are."""
    def shard(x, spec):
        d = _model_dim(spec)
        if d is None:
            return x
        dim = d + offset
        size = x.shape[dim] // axis_size
        return x.narrow(dim, index * size, size).clone(
            memory_format=torch.contiguous_format)

    return tree_map(shard, tree, spec_tree)
