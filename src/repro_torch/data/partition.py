"""Client data partitioning (paper §III-A), a verbatim numpy copy of
``repro.data.partition``.

- IID: uniform random split, equal sizes (paper: 1 000 samples/client).
- Non-IID: Dirichlet(α) label-skew with α = 1 by default — different class
  mixtures AND different dataset sizes per client, as in the paper.
"""
from __future__ import annotations

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int,
                  seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 1.0, seed: int = 0,
                        min_size: int = 8) -> list[np.ndarray]:
    """Label-skew Dirichlet split: for each class, proportions over clients
    ~ Dir(α). Re-samples until every client has ≥ min_size samples."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    for _ in range(100):
        parts: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(alpha * np.ones(num_clients))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, chunk in enumerate(np.split(idx_c, cuts)):
                parts[cid].extend(chunk.tolist())
        sizes = np.array([len(p) for p in parts])
        if sizes.min() >= min_size:
            return [np.sort(np.array(p, dtype=np.int64)) for p in parts]
    raise RuntimeError("dirichlet_partition: could not satisfy min_size")


def partition_sizes(parts: list[np.ndarray]) -> np.ndarray:
    """|D_k| vector used in the Eq. 5 weighting."""
    return np.array([len(p) for p in parts], dtype=np.float32)
