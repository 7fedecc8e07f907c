"""Carry parameter trees between the JAX package and the port as numpy.

The two packages draw different initial weights from the same seed (JAX's
threefry vs ``torch.Generator``), so weights cross only through these
functions: ``params_from_numpy(jax.tree.map(np.asarray, jax_params))`` gives
the port the reference's exact f32 weights, with the same key paths and
layouts (conv ``w`` HWIO, fc ``w`` ``(fc_in, classes)``). Strategy state
(``{"client": {"residual": tree}}`` and the like) crosses the same way
through :func:`state_from_numpy` / :func:`state_to_numpy`, so a test can
hand the port the reference's error-feedback residual rows.
"""
from __future__ import annotations

from typing import Any, Optional

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


def state_from_numpy(state: Optional[dict], device="cuda") -> Optional[dict]:
    """Strategy state (nested dict of array-likes, or None) -> tensors on
    ``device``."""
    return None if state is None else params_from_numpy(state, device)


def state_to_numpy(state: Optional[dict]) -> Optional[dict]:
    """Strategy state (nested dict of tensors, or None) -> numpy arrays."""
    return None if state is None else params_to_numpy(state)
