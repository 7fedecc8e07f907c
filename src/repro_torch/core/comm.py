"""Communication accounting (the quantity the paper optimises), port of
``repro.core.comm``.

With top-n-per-layer selection only ``n/K`` of the layer payloads travel
from clients to the server, plus a small divergence-feedback vector
(K · U float32 scalars per round). :func:`round_comm` is a function of the
selection matrix; :class:`CommMeter` keeps totals across rounds on the
host. Repricing overrides (quantized or packed uplinks) and the
client-sharded ``axis_name`` wait for their slices (ROADMAP Queue 1,
items 9 and 11).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.units import UnitMap

DIVERGENCE_SCALAR_BYTES = 4  # float32 feedback scalars


def round_comm(selection: torch.Tensor, umap: UnitMap, *,
               divergence_feedback: bool = True) -> dict:
    """Per-round communication in bytes, as 0-d float32 tensors.

    selection: (K, U) ∈ {0,1}. Returns:
      uplink_payload   — Σ_{k,u} s[k,u]·bytes(u)        (selected layers)
      uplink_feedback  — K·U·4 if divergence feedback is on (FedLDF only)
      uplink_total
      downlink         — K·total_model_bytes (server broadcast)
      fedavg_uplink    — K·total_model_bytes (reference)
      savings_frac     — 1 − uplink_total/fedavg_uplink
    """
    k = selection.shape[0]
    dev = selection.device
    unit_bytes = umap.unit_bytes_tensor(dev)
    payload = torch.sum(selection * unit_bytes[None, :])
    feedback = torch.tensor(
        k * umap.num_units * DIVERGENCE_SCALAR_BYTES if divergence_feedback
        else 0.0, dtype=torch.float32, device=dev)
    fedavg_up = (torch.tensor(k, dtype=torch.float32, device=dev)
                 * torch.tensor(umap.total_bytes, dtype=torch.float32,
                                device=dev))
    uplink = payload + feedback
    return {
        "uplink_payload": payload,
        "uplink_feedback": feedback,
        "uplink_total": uplink,
        "downlink": fedavg_up,
        "fedavg_uplink": fedavg_up,
        "savings_frac": 1.0 - uplink / fedavg_up,
    }


# ----------------------------------------------------------------------
# Device-side accumulator: a dict of float32 scalars, so a multi-round loop
# needs no per-round device→host pull.
# ----------------------------------------------------------------------
def comm_acc_init(device) -> dict:
    """Zeroed accumulator matching :class:`CommMeter`'s totals."""
    return {name: torch.zeros((), dtype=torch.float32, device=device)
            for name in ("uplink_bytes", "downlink_bytes",
                         "fedavg_uplink_bytes", "rounds")}


def comm_acc_update(acc: dict, round_stats: dict) -> dict:
    """Functional accumulate of one round's :func:`round_comm` stats."""
    return {
        "uplink_bytes": acc["uplink_bytes"] + round_stats["uplink_total"],
        "downlink_bytes": acc["downlink_bytes"] + round_stats["downlink"],
        "fedavg_uplink_bytes": (acc["fedavg_uplink_bytes"]
                                + round_stats["fedavg_uplink"]),
        "rounds": acc["rounds"] + 1.0,
    }


@dataclasses.dataclass
class CommMeter:
    """Host-side cumulative communication meter."""

    uplink_bytes: float = 0.0
    downlink_bytes: float = 0.0
    fedavg_uplink_bytes: float = 0.0
    rounds: int = 0

    def update(self, round_stats: dict) -> None:
        self.uplink_bytes += float(round_stats["uplink_total"])
        self.downlink_bytes += float(round_stats["downlink"])
        self.fedavg_uplink_bytes += float(round_stats["fedavg_uplink"])
        self.rounds += 1

    @classmethod
    def from_accumulator(cls, acc: dict) -> "CommMeter":
        """One device→host pull at the end of a multi-round run."""
        return cls(uplink_bytes=float(acc["uplink_bytes"]),
                   downlink_bytes=float(acc["downlink_bytes"]),
                   fedavg_uplink_bytes=float(acc["fedavg_uplink_bytes"]),
                   rounds=int(acc["rounds"]))

    @property
    def savings_frac(self) -> float:
        if self.fedavg_uplink_bytes == 0:
            return 0.0
        return 1.0 - self.uplink_bytes / self.fedavg_uplink_bytes
