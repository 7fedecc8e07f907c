"""Tap collection: the round builders' side of the telemetry taps, port of
``repro.telemetry.taps``.

The strategy side is :meth:`FLStrategy.telemetry_taps`: a hook whose
default derives per-layer selection counts, divergence statistics (the
Eq. 4 inputs) and summaries of the *global* state entries. The helpers
here add what only the round can see:

- :func:`client_sqsums` — sums of squares over the round's *client* state
  rows (e.g. the participants' error-feedback residuals), in f32 over
  every leaf of the K rows. In the mesh round the rows are the rank's
  K/D, so the round takes these partials locally and sums them across
  ranks inside its one cross-rank sum (no second collective, no sync);
- :func:`collect` — the round's tap dict: the strategy hook on the
  selection, divergence and global state, plus ``state_<name>_norm``
  entries from the client rows, plus the round's own extras (the packed
  uplink's wire bytes and bit widths).

Client-entry norms are taken *after* the upload transform updated them
(the EF residual update) and the global-entry summaries after
:meth:`FLStrategy.update_state`: taps describe the state the next round
starts from.

Every tap is a device tensor built from device tensors and static shapes:
nothing here reads a value on the host, so a block of rounds still
enqueues without a sync. Each norm is a fresh tensor, so no tap aliases a
buffer a later round writes in place (the EF store's scatter).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.units import tree_leaves


def sq_sum(leaves: list[torch.Tensor]) -> torch.Tensor:
    """f32 Σ x² over every element of ``leaves`` as a 0-d tensor: one
    multi-tensor norm call (``torch._foreach_norm``, f32 accumulation)
    whose per-leaf norms are squared and summed."""
    norms = torch._foreach_norm([l.float() for l in leaves])
    return torch.stack(norms).square().sum()


def client_sqsums(client: dict) -> dict:
    """Per-entry sum of squares over every leaf of the round's client-state
    rows: ``{name: f32 scalar}``."""
    return {name: sq_sum(tree_leaves(rows)) for name, rows in client.items()}


def collect(strategy, state: Optional[dict], selection: torch.Tensor,
            divs: Optional[torch.Tensor], umap,
            client_sq: Optional[dict] = None,
            extra: Optional[dict] = None) -> dict:
    """One round's tap dict (see module docstring).

    ``state`` is the round-local post-``update_state`` view (client rows
    included off the mesh). ``client_sq`` carries client partials already
    summed across the mesh's ranks (the mesh round); ``None`` means take
    them here from ``state['client']``. ``extra`` merges round-side taps
    no hook can see, e.g. the packed uplink's per-unit wire bytes and bit
    widths; its keys, like every tap's, are the same every round."""
    gview = None
    if state and state.get("global"):
        gview = {"global": state["global"]}
    taps = dict(strategy.telemetry_taps(gview, selection, divs, umap))
    if client_sq is None and state and state.get("client"):
        client_sq = client_sqsums(state["client"])
    if client_sq:
        for name, sq in client_sq.items():
            taps[f"state_{name}_norm"] = torch.sqrt(sq)
    if extra:
        taps.update(extra)
    return taps
