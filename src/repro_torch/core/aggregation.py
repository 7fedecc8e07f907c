"""Model aggregation (paper Eqs. 1, 5, 6), port of ``repro.core.aggregation``.

Two execution layouts:

- **stacked** (``vmap`` client mode): all K client models carry a leading
  client axis; aggregation is a masked weighted mean over that axis.
- **streaming** (``scan`` client mode): clients are visited one at a time
  and added into a float32 accumulator with per-unit weights, through the
  ``masked_accumulate`` kernel (one launch a client over all its leaves).

Both compute Eq. 5 ``Ĝ_u = Σ_k s[k,u]·w_k·Θ_{k,u} / Σ_m s[m,u]·w_m``; with
``s ≡ 1`` it is FedAvg (Eq. 1). :func:`stacked_psum_finalize` is the
epilogue of an additive numerator (the packed uplink builds one). The
client-sharded reductions of the reference (``axis_name``,
``stacked_psum_parts``, ``hierarchical_psum``) wait for the mesh slice
(ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.units import UnitMap, tree_map, tree_zeros_like

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
                      fallback: Pytree | None = None) -> Pytree:
    """Eq. 5 over client-stacked params (every leaf has leading K).

    ``fallback`` (usually the previous global model) is used for any unit
    whose denominator is zero (top-n selection never leaves one empty).
    """
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
