"""Participant sampling (Algorithm 1 line 5: C_t ← random(K, max(C·N, 1))),
port of ``repro.federated.sampling``.

Two kinds of streams:

- :func:`sample_clients` — host-side numpy sampling, the same stream as the
  reference's ``sampler="host"``: one seed gives the same participants in
  both packages.
- the keyed per-round streams of the multi-round engine
  (``run_training_scan``) and of ``run_training(sampler="device")``: round
  ``t`` of run ``seed`` draws from three ``torch.Generator`` s (client,
  batch, algorithm), each seeded with a splitmix64 mix of ``(seed, t,
  stream)`` (:func:`round_generators`, the counterpart of the reference's
  ``round_keys``). The streams are a pure function of ``(seed, t)``, so a
  run resumed at round ``t`` continues bit for bit, and two seeds never
  replay each other's rounds. They are not JAX's threefry streams: the
  reference's draws reach the port only through the engines' ``draws``
  argument (see :class:`KeyedDraws`).

The generators live on the CPU, so one seed gives one trajectory on the
CPU and on the card; the engine copies a block's draws to the device once.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
# stream ids of round_generators
CLIENT_STREAM, BATCH_STREAM, ALGO_STREAM = 0, 1, 2
# sample-index draws are int64 in [0, 2**62) reduced modulo the shard size:
# exact integers (a float u·s can round up to s), bias below s / 2**62
_INDEX_RANGE = 1 << 62


def sample_clients(rng: np.random.Generator, num_clients: int,
                   k: int) -> np.ndarray:
    """Uniformly sample K distinct participants for this round (host RNG)."""
    k = max(1, min(k, num_clients))
    return rng.choice(num_clients, size=k, replace=False)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, t: int, stream: int) -> int:
    """64-bit seed of ``stream`` in round ``t`` of run ``seed``: chained
    splitmix64 over the three (a bijection of each link, so distinct
    inputs collide only by 64-bit chance)."""
    x = _splitmix64(seed & _MASK64)
    x = _splitmix64(x ^ (t & _MASK64))
    return _splitmix64(x ^ stream)


def round_generators(seed: int, t: int) -> tuple[torch.Generator,
                                                 torch.Generator,
                                                 torch.Generator]:
    """Per-round (client, batch, algorithm) CPU generators; ``t`` is the
    absolute round index."""
    return tuple(torch.Generator().manual_seed(stream_seed(seed, t, s))
                 for s in (CLIENT_STREAM, BATCH_STREAM, ALGO_STREAM))


def sample_clients_torch(gen: torch.Generator, num_clients: int,
                         k: int) -> torch.Tensor:
    """K distinct participants, ``randperm(N)[:K]`` (int64, CPU)."""
    k = max(1, min(k, num_clients))
    return torch.randperm(num_clients, generator=gen)[:k]


def sample_clients_grouped(gen: torch.Generator, num_clients: int, k: int,
                           num_groups: int) -> torch.Tensor:
    """Per-affinity-group sampling: ``K/G`` distinct clients from each
    group's contiguous range ``[g·N/G, (g+1)·N/G)``, concatenated in group
    order, as the reference's ``sample_clients_grouped``;
    ``num_groups=1`` is :func:`sample_clients_torch` exactly."""
    if num_groups <= 1:
        return sample_clients_torch(gen, num_clients, k)
    if num_clients % num_groups or k % num_groups:
        raise ValueError(
            f"sample_clients_grouped: N={num_clients} and K={k} must both "
            f"divide into {num_groups} affinity groups")
    cpg, kpg = num_clients // num_groups, k // num_groups
    return torch.cat([torch.randperm(cpg, generator=gen)[:kpg] + g * cpg
                      for g in range(num_groups)])


def sample_indices(gen: torch.Generator, sizes: torch.Tensor,
                   batch: int) -> torch.Tensor:
    """``j ~ U[0, |D_c|)`` per (client, sample): the (K, batch) int64 local
    indices of :meth:`repro_torch.data.ClientShards.gather` (with
    replacement, as the reference's device draw). ``sizes`` is the
    participants' (K,) shard sizes on the CPU."""
    raw = torch.randint(0, _INDEX_RANGE, (sizes.shape[0], batch),
                        generator=gen)
    return raw % sizes.to(torch.int64)[:, None]


def local_rows(arr, rank: int, shard_size: int):
    """Rank ``rank``'s contiguous row block of a replicated, participant-
    indexed array: rows ``[rank·K/D, (rank+1)·K/D)``, a view.

    The client-sharded round keeps sampling replicated (every rank draws
    the same K participants from the same keyed streams) and splits the
    round by position, as the reference's ``P('clients')`` in-specs split
    its stacked batch. ``arr`` is any (K, ...) tensor in participant order
    (client ids, sample indices, the selection, divergence rows)."""
    row0 = rank * shard_size
    return arr[row0:row0 + shard_size]


class RoundDraws:
    """One round's draws from the keyed streams: participants, sample
    indices and the algorithm stream's uniforms, all on the CPU. Successive
    ``uniform`` calls continue one stream."""

    def __init__(self, seed: int, t: int):
        self._client, self._batch, self._algo = round_generators(seed, t)

    def clients(self, num_clients: int, k: int,
                num_groups: int = 1) -> torch.Tensor:
        return sample_clients_grouped(self._client, num_clients, k,
                                      num_groups)

    def indices(self, sizes: torch.Tensor, batch: int) -> torch.Tensor:
        return sample_indices(self._batch, sizes, batch)

    def uniform(self, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1); a random policy's Bernoulli(p) draw is
        ``uniform(shape) < p``, as ``jax.random.bernoulli``."""
        return torch.rand(tuple(shape), generator=self._algo)


class KeyedDraws:
    """The engines' default ``draws`` source: ``draws(t)`` is round ``t``'s
    :class:`RoundDraws` of run ``seed``.

    Any callable ``t -> obj`` with the same three methods (``clients(N, K,
    num_groups)``, ``indices(sizes, batch)`` and ``uniform(shape)``, all
    returning CPU tensors) can stand in for it; the parity tests inject the
    reference's ``round_keys`` draws that way."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, t: int) -> RoundDraws:
        return RoundDraws(self.seed, t)
