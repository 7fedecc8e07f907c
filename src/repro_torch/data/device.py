"""Device-resident client shards for the multi-round engine, port of
``repro.data.device``.

The host driver gathers every round batch with numpy fancy indexing and
copies it to the device (about 7.9 MB a round at the paper's setup). For the
engine the whole dataset lives on the device, so a round batch is a pure
gather:

1. the global arrays ``xs``/``ys`` are copied once;
2. per-client index partitions are padded into a dense ``(N, S)`` int32
   matrix (``S`` = the largest client shard; padding repeats the client's
   own indices cyclically, and sampling never reads past
   ``part_sizes[c]``);
3. a round batch for participants ``clients`` is two device index ops on
   the local draws ``j ~ U[0, |D_c|)`` per (client, sample):
   ``xs[part_idx[clients, j]]``.

The reference's sample-axis sharding (``with_affinity``, ``place`` and the
mesh branch of ``gather``) waits for the mesh slice (ROADMAP Queue 1, item
11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.loader import FederatedData


@dataclasses.dataclass(frozen=True)
class ClientShards:
    xs: torch.Tensor          # (total, ...) features
    ys: torch.Tensor          # (total, ...) labels
    part_idx: torch.Tensor    # (N, S) padded global indices, int32
    part_sizes: torch.Tensor  # (N,) true shard sizes, int32
    x_key: str = "images"
    y_key: str = "labels"

    @property
    def num_clients(self) -> int:
        return self.part_idx.shape[0]

    def data_sizes(self) -> torch.Tensor:
        """|D_k| vector (float32) for the Eq. 5 weighting."""
        return self.part_sizes.float()

    def bytes_per_device(self) -> int:
        """At-rest dataset bytes on the device (xs + ys)."""
        return int(sum(a.numel() * a.element_size()
                       for a in (self.xs, self.ys)))

    def to(self, device) -> "ClientShards":
        """The same shards with every array on ``device``."""
        return dataclasses.replace(
            self, xs=self.xs.to(device), ys=self.ys.to(device),
            part_idx=self.part_idx.to(device),
            part_sizes=self.part_sizes.to(device))

    # ------------------------------------------------------------------
    @staticmethod
    def from_federated(fldata: FederatedData,
                       max_shard_cap: int | None = None) -> "ClientShards":
        """Build shards (on the CPU; see :meth:`to`) from a host partition.

        Row ``c`` of the padded index matrix is ``parts[c][m % |D_c|]`` for
        every column ``m``: the real indices followed by the cyclic pad.
        ``max_shard_cap`` bounds the padded width S; clients larger than the
        cap keep only their first ``max_shard_cap`` sample indices and
        report the capped size in ``part_sizes``, so sampling and the Eq. 5
        |D_k| weights both see the truncated shard.
        """
        parts = fldata.parts
        n = len(parts)
        sizes = np.fromiter((len(p) for p in parts), dtype=np.int64,
                            count=n)
        smax = int(sizes.max())
        if max_shard_cap is not None:
            if max_shard_cap < 1:
                raise ValueError(f"max_shard_cap must be >= 1, got "
                                 f"{max_shard_cap}")
            smax = min(smax, int(max_shard_cap))
        eff = np.minimum(sizes, smax)
        flat = np.concatenate([np.asarray(p) for p in parts])
        starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
        cols = np.arange(smax, dtype=np.int64)[None, :]
        # zero-size shards never come from the partitioners, but the guard
        # keeps the modulo defined
        take = starts[:, None] + cols % np.maximum(eff, 1)[:, None]
        idx = flat[take].astype(np.int32)
        return ClientShards(
            xs=torch.from_numpy(np.asarray(fldata.xs)),
            ys=torch.from_numpy(np.asarray(fldata.ys)),
            part_idx=torch.from_numpy(idx),
            part_sizes=torch.from_numpy(eff.astype(np.int32)),
            x_key=fldata.x_key, y_key=fldata.y_key)

    # ------------------------------------------------------------------
    def gather(self, clients: torch.Tensor, j: torch.Tensor) -> dict:
        """Stacked (K, batch, ...) round batch: ``xs[part_idx[clients,
        j]]``, device index ops only. ``j`` is the (K, batch) local index
        draw of :func:`repro_torch.federated.sampling.sample_indices`
        (uniform with replacement over each client's shard)."""
        gidx = self.part_idx[clients[:, None], j]               # (K, batch)
        return {self.x_key: self.xs[gidx], self.y_key: self.ys[gidx]}
