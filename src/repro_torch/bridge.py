"""Carry parameter trees between the JAX package and the port as numpy.

The two packages draw different initial weights from the same seed (JAX's
threefry vs ``torch.Generator``), so weights cross only through these
functions: ``params_from_numpy(jax.tree.map(np.asarray, jax_params))`` gives
the port the reference's exact f32 weights, with the same key paths and
layouts (conv ``w`` HWIO, fc ``w`` ``(fc_in, classes)``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Pytree = Any


def params_from_numpy(tree: Pytree, device="cuda") -> Pytree:
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (copied, so the result never aliases a read-only numpy buffer)."""
    if isinstance(tree, dict):
        return {key: params_from_numpy(v, device) for key, v in tree.items()}
    return torch.tensor(np.asarray(tree)).to(device)


def params_to_numpy(tree: Pytree) -> Pytree:
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {key: params_to_numpy(v) for key, v in tree.items()}
    return tree.detach().cpu().numpy()
