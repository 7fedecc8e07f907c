"""Layer-unit abstraction for FedLDF (PyTorch port of ``repro.core.units``).

The paper (Eq. 3) computes one divergence scalar per *layer*. A
:class:`UnitMap` assigns every parameter leaf to one or more units:

- a *plain* top-level subtree (e.g. ``params['conv0']``) is one unit;
- a *stacked* top-level subtree (e.g. ``params['blocks']`` whose leaves all
  share a leading depth dim ``L``) contributes ``L`` units, one per depth.

Parameters are nested ``dict``s of tensors. Leaves are walked in sorted-key
order, as ``jax.tree.leaves`` walks a dict, so per-unit f32 sums add in the
same order as in the reference.

Unlike the reference, whose divergence runs under ``jax.vmap``,
:meth:`UnitMap.sq_divergence` takes client-stacked locals directly: one
kernel call over every parameter leaf covers all K clients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

Pytree = Any

# Top-level keys whose leaves carry a leading stacked-depth dimension.
DEFAULT_STACKED_KEYS = ("blocks", "enc_blocks", "dec_blocks", "experts")


def tree_leaves(tree: Pytree) -> list[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` applied leafwise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class UnitMap:
    """Static description of layer units for a parameter tree."""

    # Ordered unit names, e.g. ["blocks/0", ..., "blocks/L-1", "embed", ...].
    names: tuple[str, ...]
    # top-level key -> (unit offset, n_units). n_units > 1 means stacked.
    spans: dict[str, tuple[int, int]]
    # bytes per unit (static, from shapes/dtypes).
    unit_bytes: tuple[int, ...]
    # parameter count per unit.
    unit_params: tuple[int, ...]

    @property
    def num_units(self) -> int:
        return len(self.names)

    @property
    def total_bytes(self) -> int:
        return int(sum(self.unit_bytes))

    @property
    def total_params(self) -> int:
        return int(sum(self.unit_params))

    # ------------------------------------------------------------------
    @staticmethod
    def build(params: Pytree,
              stacked_keys: Sequence[str] = DEFAULT_STACKED_KEYS) -> "UnitMap":
        if not isinstance(params, dict):
            raise TypeError("UnitMap.build expects a top-level dict tree")
        names: list[str] = []
        spans: dict[str, tuple[int, int]] = {}
        nbytes: list[int] = []
        nparams: list[int] = []
        for key in sorted(params.keys()):
            leaves = tree_leaves(params[key])
            if not leaves:
                continue
            if key in stacked_keys:
                depth = leaves[0].shape[0]
                for leaf in leaves:
                    if leaf.ndim < 1 or leaf.shape[0] != depth:
                        raise ValueError(
                            f"stacked subtree {key!r} has inconsistent leading "
                            f"dims: {tuple(leaf.shape)} vs depth {depth}")
                spans[key] = (len(names), depth)
                per_depth_params = sum(math.prod(l.shape[1:]) for l in leaves)
                per_depth_bytes = sum(math.prod(l.shape[1:]) * l.element_size()
                                      for l in leaves)
                for d in range(depth):
                    names.append(f"{key}/{d}")
                    nbytes.append(per_depth_bytes)
                    nparams.append(per_depth_params)
            else:
                spans[key] = (len(names), 1)
                names.append(key)
                nbytes.append(sum(l.numel() * l.element_size()
                                  for l in leaves))
                nparams.append(sum(l.numel() for l in leaves))
        return UnitMap(names=tuple(names), spans=spans,
                       unit_bytes=tuple(nbytes), unit_params=tuple(nparams))

    # ------------------------------------------------------------------
    def unit_bytes_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.unit_bytes, dtype=torch.float32,
                            device=device)

    # ------------------------------------------------------------------
    def sq_divergence(self, params: Pytree, ref: Pytree,
                      sqdiff_rowsum: Callable | None = None) -> torch.Tensor:
        """Per-unit sum of squared differences, f32.

        ``params`` is either one model (leaves shaped like ``ref``'s; the
        result is ``(U,)``) or K client models stacked on a leading axis
        (leaves ``(K, ...)``; the result is ``(K, U)``). Either way each
        leaf is a ``(K·n, C)`` view against the ``(n, C)`` view of ``ref``,
        broadcast over the K clients, and each unit adds its leaves in
        tree order from 0.

        By default one :func:`repro_torch.kernels.ops.sqdiff_rowsum_leaves`
        call covers every leaf and returns the per-unit sums (one CUDA
        kernel call for CUDA tensors). ``sqdiff_rowsum(a2d, b2d) -> (rows,)``
        is instead called once a leaf, as in the reference.
        """
        from repro_torch.kernels import ops as kops  # local import; no cycle
        first_a = tree_leaves(params)[0]
        first_b = tree_leaves(ref)[0]
        stacked = first_a.ndim == first_b.ndim + 1
        k = first_a.shape[0] if stacked else 1
        a2, b2, units = [], [], []
        for key, (off, n) in self.spans.items():
            for a, b in zip(tree_leaves(params[key]), tree_leaves(ref[key])):
                a2.append(a.reshape(k * n, -1))
                b2.append(b.reshape(n, -1))
                units.append((off, n))
        if sqdiff_rowsum is None:
            out = kops.sqdiff_rowsum_leaves(a2, b2, units)
        else:
            out = torch.zeros((k, self.num_units), dtype=torch.float32,
                              device=first_a.device)
            for a, b, (off, n) in zip(a2, b2, units):
                out[:, off:off + n] = (out[:, off:off + n]
                                       + sqdiff_rowsum(a, b).reshape(k, n))
        return out if stacked else out[0]

    def divergence(self, params: Pytree, ref: Pytree,
                   sqdiff_rowsum: Callable | None = None) -> torch.Tensor:
        """Eq. 3: per-unit L2 norm of (params − ref), ``(U,)`` or ``(K, U)``
        as :meth:`sq_divergence`."""
        return torch.sqrt(self.sq_divergence(params, ref, sqdiff_rowsum))

    # ------------------------------------------------------------------
    def scale_by_unit(self, tree: Pytree, per_unit: torch.Tensor) -> Pytree:
        """Multiply each leaf by its unit's scalar (stacked: per-depth)."""
        out = {}
        for key in tree:
            off, n = self.spans[key]
            seg = per_unit[off:off + n]
            if n > 1:
                def mul(l, seg=seg, n=n):
                    return l * seg.to(l.dtype).reshape((n,) + (1,) * (l.ndim - 1))
            else:
                def mul(l, seg=seg):
                    return l * seg[0].to(l.dtype)
            out[key] = tree_map(mul, tree[key])
        return out

    def accumulate(self, acc: Pytree, tree: Pytree, per_unit: torch.Tensor,
                   masked_accumulate: Callable | None = None) -> Pytree:
        """``acc += per_unit[u(leaf)] * tree`` — the Eq. 5 inner accumulation.

        By default one :func:`repro_torch.kernels.ops.
        masked_accumulate_leaves` call covers every leaf (one CUDA kernel
        launch for CUDA tensors). ``masked_accumulate(acc2d, x2d, w_rows) ->
        acc2d`` is instead called once a leaf, as in the reference.

        Writes **in place** into ``acc``'s f32 leaves (the caller owns the
        accumulator) and returns ``acc``.
        """
        from repro_torch.kernels import ops as kops
        accs, xs, ws = [], [], []
        for key in tree:
            off, n = self.spans[key]
            w = per_unit[off:off + n]
            for a, x in zip(tree_leaves(acc[key]), tree_leaves(tree[key])):
                accs.append(a.view(n, -1))
                xs.append(x.reshape(n, -1))
                ws.append(w)
        if masked_accumulate is None:
            kops.masked_accumulate_leaves(accs, xs, ws)
        else:
            for a2, x2, w in zip(accs, xs, ws):
                a2.copy_(masked_accumulate(a2, x2, w))
        return acc

    def expand_to_leaves(self, tree: Pytree,
                         per_unit: torch.Tensor) -> Pytree:
        """A tree like ``tree`` whose leaves hold their unit's value
        broadcast to the leaf shape, in the leaf's dtype (the legacy
        compression chain's error-feedback gate)."""
        out = {}
        for key in tree:
            off, n = self.spans[key]
            seg = per_unit[off:off + n]
            if n > 1:
                def mk(l, seg=seg, n=n):
                    return seg.to(l.dtype).reshape(
                        (n,) + (1,) * (l.ndim - 1)).expand(l.shape)
            else:
                def mk(l, seg=seg):
                    return seg[0].to(l.dtype).expand(l.shape)
            out[key] = tree_map(mk, tree[key])
        return out


# ----------------------------------------------------------------------
# Generic tree helpers.
# ----------------------------------------------------------------------
def tree_zeros_like(tree: Pytree, dtype=None) -> Pytree:
    return tree_map(lambda l: torch.zeros_like(l, dtype=dtype or l.dtype),
                    tree)


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Pytree, s) -> Pytree:
    return tree_map(lambda l: l * torch.as_tensor(s, dtype=l.dtype,
                                                  device=l.device), tree)


def tree_axpy(a: Pytree, x: Pytree, alpha) -> Pytree:
    """a + alpha * x"""
    return tree_map(lambda u, v: u + torch.as_tensor(alpha, dtype=u.dtype,
                                                     device=u.device) * v,
                    a, x)


def tree_dot(a: Pytree, b: Pytree) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(a)[0].device)
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        total = total + torch.sum(u.float() * v.float())
    return total


def tree_sq_norm(tree: Pytree) -> torch.Tensor:
    return tree_dot(tree, tree)


def tree_bytes(tree: Pytree) -> int:
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


def tree_params(tree: Pytree) -> int:
    return sum(l.numel() for l in tree_leaves(tree))


def tree_cast(tree: Pytree, dtype) -> Pytree:
    return tree_map(lambda l: l.to(dtype), tree)


def tree_stack_index(tree: Pytree, i) -> Pytree:
    """Index the leading (client) axis of a stacked tree."""
    return tree_map(lambda l: l[i], tree)
