"""Beyond-paper: low-rank delta upload (FedPara-adjacent, cited as [3]),
port of ``repro.core.lowrank``.

Orthogonal to selection (Eq. 4) and quantization (core/compress.py): each
*selected* 2-D layer uploads a rank-r factorization of its delta,
``Δ ≈ U V^T`` (U: m×r, V: n×r), computed by subspace (power) iteration,
no SVD. Uplink for that layer drops from ``m·n`` to ``r·(m+n)`` floats.
Non-matrix leaves (norms, biases) upload dense (they are tiny).

Like quantization, the residual ``Δ − U V^T`` can be carried as client
error feedback so the truncation bias averages out across rounds.

The random start subspace comes from an explicit ``torch.Generator``, or is
given (``start`` / ``starts``); the reference draws it from a JAX key, and
the parity tests hand its draws to the port this way.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.core.partition import leaf_paths, tree_from_paths

Pytree = Any


def _start(n: int, r: int, generator: Optional[torch.Generator], device):
    """(n, r) f32 normal start: from ``generator``, or, without one, from a
    fresh generator seeded 0 (the reference's fixed ``PRNGKey(0)`` start:
    the same for every leaf and round)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    return torch.randn((n, r), generator=gen, device=gen.device).to(device)


def _lowrank_approx(delta: torch.Tensor, rank: int, iters: int = 2,
                    generator: Optional[torch.Generator] = None,
                    start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank-r approximation of a 2-D matrix via subspace iteration, in f32,
    cast back to ``delta``'s dtype. The (n, r) start subspace is ``start``
    if given, else drawn by :func:`_start`."""
    m, n = delta.shape
    r = min(rank, m, n)
    d32 = delta.float()
    q = (_start(n, r, generator, delta.device) if start is None
         else start.to(device=delta.device, dtype=torch.float32))
    for _ in range(iters):
        q, _ = torch.linalg.qr(d32.T @ (d32 @ q))      # (n, r)
    u = d32 @ q                                        # (m, r)
    return (u @ q.T).to(delta.dtype)


def _factorized(leaf: torch.Tensor, min_dim: int) -> bool:
    return leaf.ndim >= 2 and min(leaf.shape[-2:]) >= min_dim


def lowrank_upload(local: Pytree, global_params: Pytree, rank: int,
                   residual: Optional[Pytree] = None,
                   min_dim: int = 32,
                   generator: Optional[torch.Generator] = None,
                   starts: Optional[Sequence[Optional[torch.Tensor]]] = None
                   ) -> tuple[Pytree, Pytree]:
    """Client-side: (Θ̂ as reconstructed by the server, new residual).

    2-D leaves with both dims ≥ min_dim are rank-truncated; others dense.
    Stacked 3-D+ leaves factorize per leading index. The start subspaces:
    ``starts`` (one entry a leaf in sorted-path order: None for a dense
    leaf, (n, r) for a 2-D leaf, (lead, n, r) for a stacked one), else one
    draw a leaf (a stacked leaf: a slice) from ``generator`` in that
    order, else the fixed start of :func:`_start` everywhere.
    """
    paths, deltas = [], []
    for (path, l), (_, g) in zip(leaf_paths(local), leaf_paths(global_params)):
        paths.append(path)
        deltas.append(l - g)
    if residual is not None:
        deltas = [d + e.to(d.dtype)
                  for d, (_, e) in zip(deltas, leaf_paths(residual))]

    def approx(i, leaf):
        if not _factorized(leaf, min_dim):
            return leaf  # dense upload
        start = None if starts is None else starts[i]
        if leaf.ndim == 2:
            return _lowrank_approx(leaf, rank, generator=generator,
                                   start=start)
        flat = leaf.reshape((-1,) + leaf.shape[-2:])
        out = torch.stack([
            _lowrank_approx(x, rank, generator=generator,
                            start=None if start is None else start[j])
            for j, x in enumerate(flat)])
        return out.reshape(leaf.shape)

    recon = [approx(i, d) for i, d in enumerate(deltas)]
    new_residual = [d.float() - r_.float() for d, r_ in zip(deltas, recon)]
    theta_hat = [(g.float() + r_.float()).to(g.dtype)
                 for (_, g), r_ in zip(leaf_paths(global_params), recon)]
    return (tree_from_paths(paths, theta_hat),
            tree_from_paths(paths, new_residual))


def lowrank_bytes(global_params: Pytree, rank: int,
                  min_dim: int = 32) -> float:
    """Modeled uplink bytes for one full-model low-rank upload."""
    total = 0.0
    for _, leaf in leaf_paths(global_params):
        if _factorized(leaf, min_dim):
            lead = 1
            for d in leaf.shape[:-2]:
                lead *= d
            m, n = leaf.shape[-2:]
            total += lead * min(rank, m, n) * (m + n) * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total
