"""Model aggregation (paper Eqs. 1, 5, 6), port of ``repro.core.aggregation``.

Two execution layouts:

- **stacked** (``vmap`` client mode): all K client models carry a leading
  client axis; aggregation is a masked weighted mean over that axis.
- **streaming** (``scan`` client mode): clients are visited one at a time
  and added into a float32 accumulator with per-unit weights, through the
  ``masked_accumulate`` kernel (one launch a client over all its leaves).

Both compute Eq. 5 ``Ĝ_u = Σ_k s[k,u]·w_k·Θ_{k,u} / Σ_m s[m,u]·w_m``; with
``s ≡ 1`` it is FedAvg (Eq. 1).

The stacked layout also runs client-sharded over a
:class:`~repro_torch.launch.mesh.ClientMesh` (``aggregate_stacked(...,
mesh=)``, the reference's ``axis_name``): each rank pre-reduces its K/D
clients into additive numerators and a denominator
(:func:`stacked_psum_parts`), the ranks sum them in one collective over one
flat f32 buffer (:func:`mesh_psum`: a flat all-reduce, or the two-tier
:func:`hierarchical_psum`), and every rank divides
(:func:`stacked_psum_finalize`), so every rank holds the same new model.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.units import (UnitMap, tree_leaves, tree_map,
                                    tree_unflatten, tree_zeros_like)

Pytree = Any


def unit_weights(selection: torch.Tensor,
                 data_sizes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(client, unit) aggregation weights and per-unit denominators.

    selection: (K, U) ∈ {0,1}; data_sizes: (K,) |D_k|.
    Returns (numer_w: (K, U), denom: (U,)) with
    ``numer_w[k,u] = s[k,u]·|D_k|`` and ``denom[u] = Σ_m s[m,u]·|D_m|``.
    """
    w = selection * data_sizes[:, None].float()
    return w, w.sum(dim=0)


def aggregate_stacked(stacked_params: Pytree, umap: UnitMap,
                      selection: torch.Tensor, data_sizes: torch.Tensor,
                      fallback: Pytree | None = None, mesh=None) -> Pytree:
    """Eq. 5 over client-stacked params (every leaf has leading K).

    ``fallback`` (usually the previous global model) is used for any unit
    whose denominator is zero (top-n selection never leaves one empty).

    ``mesh`` (a :class:`~repro_torch.launch.mesh.ClientMesh`, the
    reference's ``axis_name``) makes this the cross-rank reduction of a
    client-sharded round: the inputs are then this rank's K/D rows, and
    every rank returns the same global model.
    """
    if mesh is not None:
        return _aggregate_stacked_psum(stacked_params, umap, selection,
                                       data_sizes, fallback, mesh)
    w, denom = unit_weights(selection, data_sizes)           # (K,U), (U,)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    frac = w / safe[None, :]                                 # (K, U)
    k = selection.shape[0]

    def agg_one(key: str):
        off, n = umap.spans[key]
        seg = frac[:, off:off + n]                           # (K, n)
        seg_d = denom[off:off + n]                           # (n,)

        def combine(leaf, fb=None):
            # leaf: (K, n, ...) for stacked units, (K, ...) otherwise.
            if n > 1:
                wx = seg.reshape((k, n) + (1,) * (leaf.ndim - 2))
            else:
                wx = seg.reshape((k,) + (1,) * (leaf.ndim - 1))
            out = torch.sum(leaf.float() * wx, dim=0)
            if fb is not None:
                if n > 1:
                    alive = (seg_d > 0).reshape((n,) + (1,) * (out.ndim - 1))
                else:
                    alive = seg_d[0] > 0
                out = torch.where(alive, out, fb.float())
            return out.to(leaf.dtype)

        if fallback is None:
            return tree_map(combine, stacked_params[key])
        return tree_map(combine, stacked_params[key], fallback[key])

    return {key: agg_one(key) for key in stacked_params}


def fedavg_stacked(stacked_params: Pytree, data_sizes: torch.Tensor) -> Pytree:
    """Eq. 1 — plain FedAvg over client-stacked params."""
    w = data_sizes.float()
    frac = w / w.sum()

    def combine(leaf):
        wx = frac.reshape((-1,) + (1,) * (leaf.ndim - 1))
        return torch.sum(leaf.float() * wx, dim=0).to(leaf.dtype)

    return tree_map(combine, stacked_params)


def stacked_psum_parts(stacked_params: Pytree, umap: UnitMap,
                       selection: torch.Tensor, data_sizes: torch.Tensor
                       ) -> tuple[Pytree, torch.Tensor]:
    """A rank's half of the client-sharded Eq. 5: the unnormalised f32
    numerators ``Σ_k s·w_k·Θ_k`` of its K/D clients (param-structured) and
    their (U,) denominator rows' sum. Both add across ranks, so the round
    sums them in one collective with its other additive values (the loss
    sum, the taps' client partials), then calls
    :func:`stacked_psum_finalize` on the sums."""
    w, denom_loc = unit_weights(selection, data_sizes)      # (K,U), (U,)
    k = selection.shape[0]

    def partial_one(key: str):
        off, n = umap.spans[key]
        seg = w[:, off:off + n]                              # (K, n)

        def num(leaf):
            if n > 1:
                wx = seg.reshape((k, n) + (1,) * (leaf.ndim - 2))
            else:
                wx = seg.reshape((k,) + (1,) * (leaf.ndim - 1))
            return torch.sum(leaf.float() * wx, dim=0)

        return tree_map(num, stacked_params[key])

    return {key: partial_one(key) for key in stacked_params}, denom_loc


def stacked_psum_finalize(partials: Pytree, denom: torch.Tensor,
                          umap: UnitMap, stacked_params: Pytree,
                          fallback: Pytree | None) -> Pytree:
    """Epilogue of Eq. 5 over additive numerators: divide the f32
    ``partials`` by the per-unit ``denom``, fall back to ``fallback`` (the
    previous global model) for units with no uploads, and cast back to the
    parameter dtype. With ``fallback=None`` such a unit keeps its
    numerator (divided by 1), as in the reference. ``stacked_params`` is
    only read for leaf dtypes (its leaves need not carry a client axis)."""
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))

    def finalize_one(key: str):
        off, n = umap.spans[key]
        seg_d, seg_s = denom[off:off + n], safe[off:off + n]

        def fin(p, leaf, fb=None):
            if n > 1:
                shape = (n,) + (1,) * (p.ndim - 1)
                out = p / seg_s.reshape(shape)
                alive = (seg_d > 0).reshape(shape)
            else:
                out = p / seg_s[0]
                alive = seg_d[0] > 0
            if fb is not None:
                out = torch.where(alive, out, fb.float())
            return out.to(leaf.dtype)

        fsub = None if fallback is None else fallback[key]
        if fsub is None:
            return tree_map(fin, partials[key], stacked_params[key])
        return tree_map(fin, partials[key], stacked_params[key], fsub)

    return {key: finalize_one(key) for key in stacked_params}


def _aggregate_stacked_psum(stacked_params: Pytree, umap: UnitMap,
                            selection: torch.Tensor,
                            data_sizes: torch.Tensor,
                            fallback: Pytree | None, mesh) -> Pytree:
    """Client-sharded Eq. 5 (see :func:`aggregate_stacked`): local
    partial sums, one (numerators, denominator) reduce, then the division
    and fallback on every rank."""
    partials, denom_loc = stacked_psum_parts(stacked_params, umap,
                                             selection, data_sizes)
    sums = mesh_psum({"parts": partials, "denom": denom_loc}, mesh)
    return stacked_psum_finalize(sums["parts"], sums["denom"], umap,
                                 stacked_params, fallback)


# ----------------------------------------------------------------------
# Cross-rank sums over one flat buffer
# ----------------------------------------------------------------------
def pack(tree: Pytree) -> tuple[torch.Tensor, tuple]:
    """Every leaf of the nested dict ``tree`` (:func:`tree_leaves` order)
    in one flat f32 buffer, and the layout :func:`unpack` needs."""
    leaves = tree_leaves(tree)
    buf = torch.cat([t.reshape(-1).float() for t in leaves])
    return buf, (tree, [(t.shape, t.dtype) for t in leaves])


def unpack(buf: torch.Tensor, layout: tuple) -> Pytree:
    """Inverse of :func:`pack`: the tree again, each leaf in its shape and
    dtype (a view of ``buf`` where the dtype is f32)."""
    tree, metas = layout
    pieces = buf.split([torch.Size(s).numel() for s, _ in metas])
    return tree_unflatten(tree, (p.view(s).to(d)
                                 for p, (s, d) in zip(pieces, metas)))


def hierarchical_psum(tree: Pytree, mesh, group_size: int) -> Pytree:
    """Two-tier all-reduce over the mesh's clients axis (population-scale
    rounds; on a 2-D mesh within this rank's column), port of the
    reference's.

    Tier 1: an all-reduce within each block of ``group_size`` consecutive
    client coordinates (intra-host links when the ranks of a host are
    consecutive).
    Tier 2: a ring across the G blocks, ``G − 1`` rotations by
    ``group_size`` (:meth:`ClientMesh.ring_shift`), so no single root
    absorbs all D partials. Each rank keeps the block sums it receives and
    adds them in block order, so every rank holds the same bits (the
    reference adds in arrival order, which differs between blocks once G >
    2; at G = 2 the two orders give the same bits). ``group_size ==``
    mesh size is a flat all-reduce, ``group_size == 1`` a pure ring. The
    tree (a nested dict) travels as one flat f32 buffer (:func:`pack`);
    the result equals
    a flat all-reduce up to f32 summation order."""
    d = mesh.client_size
    if d % group_size:
        raise ValueError(
            f"hierarchical_psum: group_size={group_size} must divide the "
            f"axis size {d}")
    buf, layout = pack(tree)
    num_groups = d // group_size
    if num_groups <= 1:
        return unpack(mesh.all_reduce_flat(buf), layout)
    if group_size > 1:
        buf = mesh.group_all_reduce(buf, group_size)
    g = mesh.client_rank // group_size
    sums: list = [None] * num_groups
    sums[g] = rot = buf
    for step in range(1, num_groups):
        rot = mesh.ring_shift(rot, group_size)
        sums[(g - step) % num_groups] = rot
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return unpack(total, layout)


def mesh_psum(tree: Pytree, mesh, group_size: int = 0) -> Pytree:
    """Σ of ``tree`` over the mesh's clients axis in ONE collective over
    one flat f32 buffer: a flat all-reduce, or with ``0 < group_size <``
    the axis size the two-tier :func:`hierarchical_psum` (the reference's
    round ``reduce_``)."""
    if group_size and group_size < mesh.client_size:
        return hierarchical_psum(tree, mesh, group_size)
    buf, layout = pack(tree)
    return unpack(mesh.all_reduce_flat(buf), layout)


# ----------------------------------------------------------------------
# Streaming layout (clients one at a time) — same math, O(1)-client memory.
# ----------------------------------------------------------------------
def streaming_init(global_params: Pytree) -> Pytree:
    """Float32 accumulator for Eq. 5 numerators."""
    return tree_zeros_like(global_params, dtype=torch.float32)


def streaming_add(acc: Pytree, client_params: Pytree, umap: UnitMap,
                  client_frac: torch.Tensor) -> Pytree:
    """acc += client_frac[u] * Θ_k (client_frac = w[k]/denom, shape (U,)).

    Updates the private accumulator ``acc`` in place and returns it.
    """
    return umap.accumulate(acc, client_params, client_frac)


def streaming_finalize(acc: Pytree, umap: UnitMap, denom: torch.Tensor,
                       fallback: Pytree) -> Pytree:
    """Replace zero-denominator units with the previous global model and
    cast back to the parameter dtype."""
    alive = (denom > 0).float()
    kept = umap.scale_by_unit(acc, alive)
    fb = umap.scale_by_unit(fallback, 1.0 - alive)
    return tree_map(lambda a, b, g: (a + b.float()).to(g.dtype),
                    kept, fb, fallback)
