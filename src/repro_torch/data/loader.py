"""Batching for federated simulation.

``FederatedData`` owns the global arrays plus per-client index partitions and
serves stacked per-round batches: for a participant set ``C_t`` of K clients
it returns leaves shaped ``(K, batch, ...)`` ready for ``vmap`` (parallel
clients) or a loop over clients (sequential) — see federated/server.py.
A verbatim numpy copy of ``repro.data.loader``: one seed gives the same
arrays in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.partition import partition_sizes


@dataclasses.dataclass
class FederatedData:
    xs: np.ndarray                    # (N, ...) features (images or tokens)
    ys: np.ndarray                    # (N, ...) labels
    parts: list[np.ndarray]           # per-client index sets
    x_key: str = "images"
    y_key: str = "labels"

    @property
    def num_clients(self) -> int:
        return len(self.parts)

    def data_sizes(self) -> np.ndarray:
        return partition_sizes(self.parts)

    def client_batch(self, client: int, batch: int,
                     rng: np.random.Generator) -> dict:
        idx = self.parts[client]
        pick = rng.choice(idx, size=batch, replace=len(idx) < batch)
        return {self.x_key: self.xs[pick], self.y_key: self.ys[pick]}

    def round_batch(self, clients: np.ndarray, batch: int,
                    rng: np.random.Generator) -> dict:
        """Stacked (K, batch, ...) batch for the participant set."""
        parts = [self.client_batch(int(c), batch, rng) for c in clients]
        return {
            self.x_key: np.stack([p[self.x_key] for p in parts]),
            self.y_key: np.stack([p[self.y_key] for p in parts]),
        }


def lm_federated(tokens: np.ndarray, domains: np.ndarray,
                 num_clients: int, by_domain: bool = True,
                 seed: int = 0) -> FederatedData:
    """Wrap an LM token set as federated data (clients = domains: non-IID)."""
    rng = np.random.default_rng(seed)
    if by_domain:
        order = np.argsort(domains, kind="stable")
        parts = [np.sort(p) for p in np.array_split(order, num_clients)]
    else:
        parts = [np.sort(p) for p in
                 np.array_split(rng.permutation(len(tokens)), num_clients)]
    inputs = tokens[:, :-1]
    labels = tokens[:, 1:]
    return FederatedData(xs=inputs, ys=labels, parts=parts,
                         x_key="tokens", y_key="labels")
