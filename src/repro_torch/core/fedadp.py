"""FedADP baseline [6]: adaptive pruning with the *neuron* as pruning unit,
port of ``repro.core.fedadp``.

Each client uploads only its most-changed neurons (the last axis of a
weight: dense output columns, conv output channels); the server aggregates
element-wise over the uploaded entries. This is the finer-granularity
comparison point the paper contrasts with FedLDF's layer-granularity
selection (paper §III, pruning ratio chosen for equal communication
overhead). On a client mesh the aggregation splits in two halves,
:func:`fedadp_psum_parts` (a rank's masked partials, summed across ranks)
and :func:`fedadp_psum_finalize` (the division on every rank).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.units import tree_leaves, tree_map

Pytree = Any


def _neuron_axis_scores(delta: torch.Tensor) -> torch.Tensor:
    """(K, out) importance per output neuron (last axis) of client-stacked
    f32 deltas: L2 over every other axis but the client's."""
    if delta.ndim == 2:
        return delta.abs()
    return torch.sqrt(torch.sum(delta ** 2,
                                dim=tuple(range(1, delta.ndim - 1))))


def _n_keep(out: int, keep_frac: float) -> int:
    return max(1, int(round(keep_frac * out)))


def neuron_masks(client_params: Pytree, global_params: Pytree,
                 keep_frac: float) -> Pytree:
    """Per-leaf {0,1} f32 masks keeping the top ``keep_frac`` of output
    neurons by update magnitude. ``client_params`` leaves carry a leading
    client axis K (the reference calls its version under ``vmap``); among
    equal scores the lower neuron index is kept, as ``jax.lax.top_k``."""

    def mask_leaf(theta, g):
        delta = theta.float() - g.float()[None]
        scores = _neuron_axis_scores(delta)                   # (K, out)
        out = scores.shape[1]
        order = torch.sort(scores, dim=1, descending=True,
                           stable=True).indices[:, :_n_keep(out, keep_frac)]
        kept = torch.zeros_like(scores).scatter_(1, order, 1.0)
        return kept.reshape((kept.shape[0],) + (1,) * (theta.ndim - 2)
                            + (out,)).expand(theta.shape)

    return tree_map(mask_leaf, client_params, global_params)


def aggregate_fedadp(stacked_params: Pytree, global_params: Pytree,
                     data_sizes: torch.Tensor, keep_frac: float) -> Pytree:
    """Element-wise masked aggregation over the client axis.

    stacked_params: leaves (K, ...). Falls back to the previous global value
    where no client uploaded an entry.
    """
    masks = neuron_masks(stacked_params, global_params, keep_frac)
    w = data_sizes.float()

    def combine(theta, m, g):
        wx = w.reshape((-1,) + (1,) * (theta.ndim - 1))
        numer = torch.sum(theta.float() * m * wx, dim=0)
        denom = torch.sum(m * wx, dim=0)
        alive = denom > 0
        agg = torch.where(alive, numer / torch.where(alive, denom, 1.0),
                          g.float())
        return agg.to(g.dtype)

    return tree_map(combine, stacked_params, masks, global_params)


def fedadp_psum_parts(stacked_params: Pytree, global_params: Pytree,
                      data_sizes: torch.Tensor,
                      keep_frac: float) -> tuple[Pytree, Pytree]:
    """A rank's halves of :func:`aggregate_fedadp` for the mesh round's
    cross-rank sum: masked numerators ``Σ_k θ·m·w`` and element-wise
    denominators ``Σ_k m·w`` over its K/D clients, both param-structured
    f32 trees and additive across ranks, so summing them and dividing
    (:func:`fedadp_psum_finalize`) gives the one-device aggregation up to
    f32 summation order."""
    masks = neuron_masks(stacked_params, global_params, keep_frac)
    w = data_sizes.float()

    def wx_for(theta):
        return w.reshape((-1,) + (1,) * (theta.ndim - 1))

    numer = tree_map(lambda theta, m: torch.sum(theta.float() * m
                                                * wx_for(theta), dim=0),
                     stacked_params, masks)
    denom = tree_map(lambda theta, m: torch.sum(m * wx_for(theta), dim=0),
                     stacked_params, masks)
    return numer, denom


def fedadp_psum_finalize(numer: Pytree, denom: Pytree,
                         global_params: Pytree) -> Pytree:
    """The epilogue on every rank: element-wise division, falling back to
    the previous global value where no client uploaded an entry."""

    def combine(n, d, g):
        alive = d > 0
        agg = torch.where(alive, n / torch.where(alive, d, 1.0), g.float())
        return agg.to(g.dtype)

    return tree_map(combine, numer, denom, global_params)


def comm_bytes(global_params: Pytree, num_clients: int,
               keep_frac: float) -> float:
    """Modeled uplink bytes per round: kept neurons + per-neuron index
    overhead (4 B each, standard sparse-upload encoding)."""
    total = 0.0
    for leaf in tree_leaves(global_params):
        out = leaf.shape[-1] if leaf.ndim >= 1 else 1
        per_neuron = leaf.numel() // out * leaf.element_size()
        total += _n_keep(out, keep_frac) * (per_neuron + 4)
    return num_clients * total
