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

On a client mesh (:class:`~repro_torch.launch.mesh.ClientMesh`, one rank a
device) :meth:`ClientShards.place` puts the dataset on the rank's device,
whole (every rank may need any sample) or, with ``shard_samples=True``,
only the rank's block of a **sample-axis sharded** layout:
:meth:`ClientShards.with_affinity` permutes the samples into contiguous
per-group blocks keyed by a static client→group assignment (group ``g``
owns clients ``[g·N/G, (g+1)·N/G)``), rank ``g`` keeps block ``g`` (about
1/D of the dataset's bytes) and :meth:`ClientShards.gather` reads rank-local
rows, ``row − g·group_block``. The cohort is then drawn per affinity group
(:func:`repro_torch.federated.sampling.sample_clients_grouped`), so rank
``g``'s K/D participant rows are clients whose samples it holds.
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
    # affinity layout (with_affinity): samples in num_groups contiguous
    # blocks of group_block rows; 0 / 1 when the layout is the loader's
    group_block: int = 0
    num_groups: int = 1
    # the global row of xs[0]: g·group_block when this rank holds only its
    # block of a sample-sharded layout (place(..., shard_samples=True))
    sample_base: int = 0

    @property
    def num_clients(self) -> int:
        return self.part_idx.shape[0]

    @property
    def is_block(self) -> bool:
        """Whether these shards hold one rank's block of a sample-sharded
        layout (:meth:`place` with ``shard_samples=True``)."""
        return bool(self.group_block) and \
            self.xs.shape[0] < self.num_groups * self.group_block

    def data_sizes(self) -> torch.Tensor:
        """|D_k| vector (float32) for the Eq. 5 weighting."""
        return self.part_sizes.float()

    def bytes_per_device(self) -> int:
        """At-rest dataset bytes on the device (xs + ys; one rank's block
        under sample sharding)."""
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
    def with_affinity(self, num_groups: int) -> "ClientShards":
        """Re-layout the samples into contiguous per-group blocks.

        Group ``g`` owns clients ``[g·N/G, (g+1)·N/G)``; its block holds
        those clients' samples back to back, padded to the largest group's
        sample total (``group_block``) with copies of row 0, which nothing
        addresses. ``part_idx`` is rewritten into the new rows with the
        same cyclic-pad rule, so :meth:`gather` returns the same batch
        values for any ``(clients, j)``: the re-layout only moves data.
        The index arithmetic runs on the host; the arrays stay on their
        device. A layout of ``num_groups`` already is returned as is."""
        n = self.num_clients
        if num_groups <= 1:
            return self
        if self.num_groups == num_groups and self.group_block:
            return self
        if n % num_groups:
            raise ValueError(
                f"with_affinity: num_clients={n} must divide into "
                f"{num_groups} groups")
        if self.is_block:
            raise ValueError("with_affinity: these shards hold one rank's "
                             "block of a sample-sharded layout")
        part_idx = self.part_idx.cpu().numpy()
        sizes = self.part_sizes.cpu().numpy().astype(np.int64)
        cpg = n // num_groups
        blk = int(sizes.reshape(num_groups, cpg).sum(axis=1).max())
        # destination of each client's first sample: its group's base plus
        # the exclusive cumulative shard size within the group
        csum = np.cumsum(sizes) - sizes
        gstart = csum.reshape(num_groups, cpg)[:, 0]
        dest0 = (np.repeat(np.arange(num_groups, dtype=np.int64) * blk, cpg)
                 + (csum - np.repeat(gstart, cpg)))
        cols = np.arange(part_idx.shape[1], dtype=np.int64)[None, :]
        valid = cols < sizes[:, None]
        order = np.zeros(num_groups * blk, dtype=np.int64)
        order[(dest0[:, None] + cols)[valid]] = part_idx[valid]
        new_idx = (dest0[:, None]
                   + cols % np.maximum(sizes, 1)[:, None]).astype(np.int32)
        take = torch.from_numpy(order).to(self.xs.device)
        return dataclasses.replace(
            self, xs=self.xs[take], ys=self.ys[take],
            part_idx=torch.from_numpy(new_idx).to(self.part_idx.device),
            group_block=blk, num_groups=num_groups)

    def place(self, mesh, shard_samples: bool = False) -> "ClientShards":
        """The shards on this rank of ``mesh`` (its device).

        ``shard_samples=False``: the whole dataset on every rank: the
        round's participants are any K of the N clients, so any rank may
        need any sample, and every rank pays the whole dataset's memory.

        ``shard_samples=True`` (a mesh of D > 1 ranks): the layout of
        :meth:`with_affinity` (D groups; applied here if the shards are not
        laid out so already) and only rank ``g``'s block of
        ``group_block`` rows on its device, about 1/D of the bytes; the
        (small) index matrices stay whole. :meth:`gather` then reads
        rank-local rows and needs a per-group cohort (the drivers draw one
        when ``num_groups > 1``)."""
        from repro_torch.launch.mesh import client_mesh_size
        d = client_mesh_size(mesh)
        if not shard_samples or d <= 1:
            return self.to(mesh.device)
        src = self.with_affinity(d)
        lo = mesh.client_rank * src.group_block
        if src.is_block:                 # placed so before
            if src.sample_base != lo:
                raise ValueError(
                    f"place: these shards hold the block at row "
                    f"{src.sample_base}, not rank {mesh.client_rank}'s "
                    "(client coordinate)")
            return src.to(mesh.device)
        return dataclasses.replace(
            src, xs=src.xs[lo:lo + src.group_block].to(mesh.device,
                                                       copy=True),
            ys=src.ys[lo:lo + src.group_block].to(mesh.device, copy=True),
            part_idx=src.part_idx.to(mesh.device),
            part_sizes=src.part_sizes.to(mesh.device), sample_base=lo)

    # ------------------------------------------------------------------
    def gather(self, clients: torch.Tensor, j: torch.Tensor) -> dict:
        """Stacked (K, batch, ...) round batch: ``xs[part_idx[clients,
        j]]``, device index ops only. ``j`` is the (K, batch) local index
        draw of :func:`repro_torch.federated.sampling.sample_indices`
        (uniform with replacement over each client's shard). Under sample
        sharding the rows are rank-local, ``part_idx[clients, j] −
        sample_base``: ``clients`` must be in this rank's group."""
        gidx = self.part_idx[clients[:, None], j]               # (K, batch)
        if self.sample_base:
            gidx = gidx - self.sample_base
        return {self.x_key: self.xs[gidx], self.y_key: self.ys[gidx]}
