"""Pytree checkpoint I/O, port of ``repro.checkpoint.io``: npz files with
'/'-joined tree paths as keys (tuples and lists as ``#i`` steps), so load
needs no template.

The format is the reference's, so a file written by one package loads in
the other: bf16 leaves are stored as two-byte void (``|V2``) arrays, which
is how numpy saves the reference's ``ml_dtypes.bfloat16`` arrays, and are
read back as ``torch.bfloat16`` with the same bits
(:mod:`repro_torch.bridge`).
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy

Pytree = Any
_SEP = "/"


def _flatten(tree: Pytree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip(_SEP)] = tensor_to_numpy(tree)
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def save_pytree(path: str, tree: Pytree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def save_server_state(path: str, params: Pytree,
                      state: Pytree | None = None) -> None:
    """Persist an FL server snapshot: global params plus the strategy's
    cross-round state (``TrainLog.final_state``); ``state=None`` saves
    params only."""
    tree = {"params": params}
    if state is not None:
        tree["state"] = state
    save_pytree(path, tree)


def load_server_state(path: str, device="cuda"
                      ) -> tuple[Pytree, Pytree | None]:
    """Inverse of :func:`save_server_state` -> ``(params, state)`` with
    ``state=None`` when the snapshot was stateless."""
    tree = load_pytree(path, device)
    if "params" not in tree:
        raise ValueError(
            f"{path!r} is not a server-state snapshot (no 'params' root; "
            "was it written with save_pytree instead of save_server_state?)")
    return tree["params"], tree.get("state")


def load_pytree(path: str, device="cuda") -> Pytree:
    """The tree saved at ``path``, its leaves as tensors on ``device``."""
    with np.load(path, allow_pickle=False) as data:
        root: dict = {}
        for key in data.files:
            parts = key.split(_SEP)
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = tensor_from_numpy(data[key], device)

    def delistify(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
                return tuple(delistify(v) for _, v in items)
            return {k: delistify(v) for k, v in node.items()}
        return node

    return delistify(root)
