"""Communication accounting (the quantity the paper optimises), port of
``repro.core.comm``.

With top-n-per-layer selection only ``n/K`` of the layer payloads travel
from clients to the server, plus a small divergence-feedback vector
(K · U float32 scalars per round). :func:`round_comm` is a function of the
selection matrix; :class:`CommMeter` keeps totals across rounds on the
host. A compressed uplink reprices the payload through
``param_bytes_override`` (the legacy chain's uniform b/8 bytes a
parameter) or ``unit_bytes_override`` (the packed wire format's per-unit
bytes). On a client mesh :func:`round_comm` takes ``mesh=`` (the
reference's ``axis_name``) and sums the ranks' local rows;
:func:`agg_tier_bytes` splits the round's aggregation traffic by tier.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.units import UnitMap

DIVERGENCE_SCALAR_BYTES = 4  # float32 feedback scalars


def round_comm(selection: torch.Tensor, umap: UnitMap, *,
               divergence_feedback: bool = True,
               param_bytes_override: float | None = None,
               unit_bytes_override: torch.Tensor | None = None,
               mesh=None) -> dict:
    """Per-round communication in bytes, as 0-d float32 tensors.

    selection: (K, U) ∈ {0,1}. On a client mesh (``mesh``, a
    :class:`~repro_torch.launch.mesh.ClientMesh`) pass this rank's local
    rows: the float64 payload sum and the client count are summed over the
    ranks, so every rank returns the same global totals. (The sharded
    round itself prices the full replicated selection and needs no
    collective for it.) ``param_bytes_override`` reprices every
    parameter uniformly (legacy quantized pricing, e.g. 1.0 for int8).
    ``unit_bytes_override`` — a (U,) per-unit byte vector, usually
    ``PackedPayload.unit_wire_bytes`` — takes precedence.

    The payload is summed in float64 and rounded to f32 once, so it is the
    f32 nearest the exact byte count (the reference sums in f32, which at
    full-width VGG-9 can land a few bytes off). Returns:
      uplink_payload   — Σ_{k,u} s[k,u]·bytes(u)        (selected layers)
      uplink_feedback  — K·U·4 if divergence feedback is on (FedLDF only)
      uplink_total
      downlink         — K·total_model_bytes (server broadcast)
      fedavg_uplink    — K·total_model_bytes (reference)
      savings_frac     — 1 − uplink_total/fedavg_uplink
    """
    k = selection.shape[0]
    dev = selection.device
    if mesh is not None:
        k *= mesh.client_size           # global K across the mesh
    if unit_bytes_override is not None:
        unit_bytes = torch.as_tensor(unit_bytes_override,
                                     dtype=torch.float32, device=dev)
    else:
        scale = (1.0 if param_bytes_override is None
                 else param_bytes_override / 4.0)
        # the byte counts as exact float64 integers: in f32 a unit of over
        # 2**24 B may round (a full-width LLM's layer does)
        unit_bytes = umap.unit_bytes_tensor(dev, torch.float64) * scale
    payload = torch.sum(selection.double() * unit_bytes.double()[None, :])
    if mesh is not None:
        payload = mesh.all_reduce_flat(payload.reshape(1))[0]
    payload = payload.float()
    # constants are filled on the device (no host copy, no sync)
    feedback = torch.full(
        (), k * umap.num_units * DIVERGENCE_SCALAR_BYTES
        if divergence_feedback else 0.0, dtype=torch.float32, device=dev)
    fedavg_up = (torch.full((), k, dtype=torch.float32, device=dev)
                 * torch.full((), umap.total_bytes, dtype=torch.float32,
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


def agg_tier_bytes(payload_bytes: float, axis_size: int,
                   group_size: int = 0) -> dict:
    """A round's aggregation traffic by tier for the flat or two-tier
    cross-rank reduce (:func:`repro_torch.core.aggregation.
    hierarchical_psum`), port of the reference's, values as Python floats.

    ``payload_bytes`` is ONE rank's reduce payload P (its Eq. 5 numerator
    tree). ``group_size`` 0 or ``axis_size`` is the flat reduce. Static per
    configuration (topology × payload), added to the round's comm record
    after the reduce:

      agg_payload_bytes        — P
      agg_intra_bytes          — bytes a round on intra-group links (0 for
                                 the flat reduce)
      agg_cross_bytes          — bytes a round across group boundaries
                                 (flat: D−1 partials to the root; two-tier:
                                 the leaders' ring moves G·(G−1) payloads)
      agg_cross_bytes_per_host — the busiest participant's cross-tier
                                 share, sent and received (flat 2·(D−1)·P;
                                 two-tier 2·(G−1)·P)
      agg_groups               — G
      agg_tiers                — 1 (flat) or 2
    """
    d = int(axis_size)
    gs = int(group_size) or d
    if d % gs:
        raise ValueError(f"agg_tier_bytes: group_size={gs} must divide "
                         f"axis_size={d}")
    p = float(payload_bytes)
    num_groups = d // gs
    if num_groups <= 1:
        return {"agg_payload_bytes": p,
                "agg_intra_bytes": 0.0,
                "agg_cross_bytes": (d - 1) * p,
                "agg_cross_bytes_per_host": 2.0 * (d - 1) * p,
                "agg_groups": 1.0, "agg_tiers": 1.0}
    return {"agg_payload_bytes": p,
            "agg_intra_bytes": float(d - num_groups) * p,
            "agg_cross_bytes": float(num_groups * (num_groups - 1)) * p,
            "agg_cross_bytes_per_host": 2.0 * (num_groups - 1) * p,
            "agg_groups": float(num_groups), "agg_tiers": 2.0}


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

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "uplink_MB": self.uplink_bytes / 1e6,
            "downlink_MB": self.downlink_bytes / 1e6,
            "fedavg_uplink_MB": self.fedavg_uplink_bytes / 1e6,
            "uplink_savings_frac": self.savings_frac,
        }
