"""The FL engine's 'model'-axis placement, port of the FL half of
``repro.launch.sharding``: FSDP of the params, the frozen base and the
per-client stores over the 2-D ``('clients', 'model')`` mesh
(:func:`repro_torch.launch.mesh.make_client_mesh` with ``model`` M > 1).

Every parameter leaf is cut 1/M along its largest dim that M divides; the
leading unit axis of every stacked key (``core.units.
DEFAULT_STACKED_KEYS``, ``experts`` included) is never cut, and a leaf
with no such dim (every 1-D leaf) stays whole on every rank. A spec is a
plain tuple with one entry a dim, ``"model"`` or None (``()`` for a
replicated leaf), equal to ``tuple()`` of the reference's
``PartitionSpec``. :func:`tree_all_gather` and :func:`tree_shard_slice`
move leaves between the rank's shards and whole values: one all-gather
over the rank's model row, and a local slice, both exact. On the 1-D mesh
(or without one) every spec is ``()`` and every leaf whole.

``auto_spec`` and ``param_specs`` are ported only as far as
:func:`fl_param_specs` needs them (``model_only=True``). Their data-axis
half, ``batch_specs`` and ``to_named`` serve only the reference's XLA
dry-run and wait for that tooling (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.units import (DEFAULT_STACKED_KEYS, tree_leaves,
                                    tree_map, tree_unflatten)
from repro_torch.launch.mesh import MODEL_AXIS, model_mesh_size

Pytree = Any

STACKED_TOPKEYS = ("blocks", "enc_blocks", "dec_blocks")
# every leaf's bytes start on this boundary in the gather's byte buffer, so
# that each piece views back into its dtype
_ALIGN = 16


def _data_axes_not_ported(fn: str):
    return NotImplementedError(
        f"{fn}(model_only=False): the data-axis half serves only the "
        "reference's XLA dry-run, which is not ported (ROADMAP Queue 1, "
        "item 12)")


def auto_spec(shape: tuple[int, ...], mesh, *, skip_leading: bool = False,
              model_axis: str = MODEL_AXIS,
              model_only: bool = False) -> tuple:
    """The spec of one array shape: its largest dim (the later of equal
    ones) that the mesh's ``model_axis`` size divides → ``model_axis``,
    the leading dim skipped with ``skip_leading``; every other dim
    replicated."""
    if not model_only:
        raise _data_axes_not_ported("auto_spec")
    size = int(mesh.shape[model_axis])
    cands = [d for d in range(1 if skip_leading else 0, len(shape))
             if shape[d] >= size and shape[d] % size == 0]
    spec: list = [None] * len(shape)
    if cands:
        spec[max(cands, key=lambda d: (shape[d], d))] = model_axis
    return tuple(spec)


def param_specs(params_shape: Pytree, mesh, model_only: bool = False,
                stacked_keys: tuple[str, ...] = STACKED_TOPKEYS) -> Pytree:
    """The spec tree of a parameter tree (leaves: anything with a
    ``.shape``): :func:`auto_spec` of every leaf of two or more dims, its
    leading depth dim skipped under ``stacked_keys``; ``()`` for the
    rest."""
    if not model_only:
        raise _data_axes_not_ported("param_specs")

    def assign(top: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return ()
        return auto_spec(shape, mesh, skip_leading=top in stacked_keys,
                         model_only=True)

    return {top: tree_map(lambda l, top=top: assign(top, l), sub)
            for top, sub in params_shape.items()}


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
