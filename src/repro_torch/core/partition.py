"""Trainable/frozen parameter partition — the adapter fine-tuning seam, port
of ``repro.core.partition``.

FedLDF's premise (Eq. 3-5) is that only the *divergent subset* of the model
needs to travel; a :class:`ParamPartition` makes that subset an explicit
engine-level contract. Every parameter leaf is classified

- **trainable** — receives local gradients, travels the wire, is scored by
  the Eq. 3 divergence, and is eligible for error feedback / quantization
  (the unit map, strategy state, comm accounting and the packed wire format
  are all built over this sub-tree only); or
- **frozen** — the device-resident base model: placed once, closed over by
  local training, never uploaded.

``FLConfig(partition=None)`` (the default) is the everything-trainable
behaviour; an all-trainable partition gives the same rounds bit for bit.

The partition itself is static data: leaf *paths* ("/"-joined dict keys,
e.g. ``"blocks/attn/lora/wq/a"``), never tensors, in a frozen, hashable
dataclass that rides :class:`~repro_torch.federated.server.FLConfig`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Sequence

Pytree = Any


def leaf_paths(tree: Pytree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield ("/"-joined path, leaf) pairs of a nested-dict tree in
    sorted-key order (the order of
    :func:`repro_torch.core.units.tree_leaves`)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _assign(out: dict, path: str, leaf) -> None:
    keys = path.split("/")
    node = out
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf


def tree_from_paths(paths: Sequence[str], leaves: Sequence[Any]) -> dict:
    """The nested dict whose :func:`leaf_paths` are ``zip(paths, leaves)``."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        _assign(out, path, leaf)
    return out


@dataclasses.dataclass(frozen=True)
class ParamPartition:
    """Static trainable/frozen classification of a parameter tree.

    Holds only leaf paths (hashable tuples), never tensors.
    """

    trainable_paths: tuple[str, ...]
    frozen_paths: tuple[str, ...]

    def __post_init__(self):
        overlap = set(self.trainable_paths) & set(self.frozen_paths)
        if overlap:
            raise ValueError(
                f"paths classified both trainable and frozen: "
                f"{sorted(overlap)[:4]}")
        if not self.trainable_paths:
            raise ValueError(
                "a ParamPartition needs at least one trainable leaf "
                "(an all-frozen model has nothing to train or upload)")

    # ------------------------------------------------------------------
    @staticmethod
    def build(params: Pytree,
              is_trainable: Callable[[str, Any], bool]) -> "ParamPartition":
        """Classify every leaf of ``params`` with
        ``is_trainable(path, leaf)``."""
        if not isinstance(params, dict):
            raise TypeError("ParamPartition.build expects a top-level dict "
                            "tree (the engine param layout)")
        train, frozen = [], []
        for path, leaf in leaf_paths(params):
            (train if is_trainable(path, leaf) else frozen).append(path)
        return ParamPartition(tuple(train), tuple(frozen))

    @staticmethod
    def by_keys(params: Pytree,
                trainable_keys: tuple[str, ...] | list[str]
                ) -> "ParamPartition":
        """Partition on top-level keys: subtrees named in ``trainable_keys``
        are trainable, everything else frozen."""
        keys = set(trainable_keys)
        unknown = keys - set(params)
        if unknown:
            raise KeyError(f"trainable_keys not in params: {sorted(unknown)}")
        return ParamPartition.build(
            params, lambda path, _: path.split("/", 1)[0] in keys)

    @staticmethod
    def by_substring(params: Pytree, marker: str) -> "ParamPartition":
        """Leaves with a path segment equal to ``marker`` (e.g. ``"lora"``)
        are trainable; the rest are the frozen base."""
        return ParamPartition.build(
            params, lambda path, _: marker in path.split("/"))

    # ------------------------------------------------------------------
    @property
    def all_trainable(self) -> bool:
        return not self.frozen_paths

    def _check(self, params: Pytree) -> None:
        have = [p for p, _ in leaf_paths(params)]
        want = set(self.trainable_paths) | set(self.frozen_paths)
        missing = want - set(have)
        extra = set(have) - want
        if missing or extra:
            raise ValueError(
                "params do not match this partition "
                f"(missing={sorted(missing)[:4]}, "
                f"unclassified={sorted(extra)[:4]}) — rebuild the "
                "partition against the model you are training")

    def split(self, params: Pytree) -> tuple[Pytree, Pytree]:
        """``params -> (trainable, frozen)`` complementary nested dicts of
        the same tensors (no copy). Raises ``ValueError`` unless the
        partition's paths cover ``params`` exactly."""
        self._check(params)
        tset = set(self.trainable_paths)
        train: dict = {}
        frozen: dict = {}
        for path, leaf in leaf_paths(params):
            _assign(train if path in tset else frozen, path, leaf)
        return train, frozen

    def merge(self, trainable: Pytree, frozen: Pytree) -> Pytree:
        """Inverse of :meth:`split`: reassemble the full param tree."""
        out: dict = {}
        for tree in (frozen, trainable):
            for path, leaf in leaf_paths(tree):
                _assign(out, path, leaf)
        return out


def partition_counts(partition: ParamPartition, params: Pytree) -> dict:
    """Static trainable/frozen param and byte totals (bytes from each
    leaf's ``element_size()``)."""
    tset = set(partition.trainable_paths)
    out = {"trainable_params": 0, "frozen_params": 0,
           "trainable_bytes": 0, "frozen_bytes": 0}
    for path, leaf in leaf_paths(params):
        kind = "trainable" if path in tset else "frozen"
        n = math.prod(leaf.shape)
        out[f"{kind}_params"] += n
        out[f"{kind}_bytes"] += n * leaf.element_size()
    return out
