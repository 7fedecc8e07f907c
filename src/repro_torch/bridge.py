"""Carry parameter trees between the JAX package and the port as numpy.

The two packages draw different initial weights from the same seed (JAX's
threefry vs ``torch.Generator``), so weights cross only through these
functions: ``params_from_numpy(jax.tree.map(np.asarray, jax_params))`` gives
the port the reference's exact f32 weights, with the same key paths and
layouts (conv ``w`` HWIO, fc ``w`` ``(fc_in, classes)``). Strategy state
(``{"client": {"residual": tree}}`` and the like) crosses the same way
through :func:`state_from_numpy` / :func:`state_to_numpy`, so a test can
hand the port the reference's error-feedback residual rows.

bf16 crosses bit for bit. numpy has no bf16 of its own: a JAX bf16 array
converts to an ``ml_dtypes.bfloat16`` array, and an ``.npz`` written by
either package loads its bf16 leaves as two-byte void (``|V2``). Both are
read through an ``int16`` view of the same bytes and viewed as
``torch.bfloat16`` (no ``ml_dtypes`` needed); :func:`params_to_numpy`
gives bf16 tensors back as ``|V2`` arrays, as the reference's files hold
them.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

Pytree = Any


def _is_bf16_bytes(arr: np.ndarray) -> bool:
    """An ``ml_dtypes.bfloat16`` array or a two-byte void (``|V2``) one."""
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One array-like -> a tensor on ``device`` (copied); bf16 bytes
    (``ml_dtypes.bfloat16`` or ``|V2``) become ``torch.bfloat16``."""
    arr = np.asarray(arr)
    if _is_bf16_bytes(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.tensor(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array on the host; bf16 as ``|V2`` bytes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def params_from_numpy(tree: Pytree, device="cuda") -> Pytree:
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (copied, so the result never aliases a read-only numpy buffer)."""
    if isinstance(tree, dict):
        return {key: params_from_numpy(v, device) for key, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_to_numpy(tree: Pytree) -> Pytree:
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {key: params_to_numpy(v) for key, v in tree.items()}
    return tensor_to_numpy(tree)


def state_from_numpy(state: Optional[dict], device="cuda") -> Optional[dict]:
    """Strategy state (nested dict of array-likes, or None) -> tensors on
    ``device``."""
    return None if state is None else params_from_numpy(state, device)


def state_to_numpy(state: Optional[dict]) -> Optional[dict]:
    """Strategy state (nested dict of tensors, or None) -> numpy arrays."""
    return None if state is None else params_to_numpy(state)
