"""Built-in strategies: the paper's FedLDF, its baselines and FedLP, port of
``repro.federated.strategies.builtin``.

The random policies (random, HDFL, FedLP) draw from the round's algorithm
stream ``uniform`` (see :mod:`repro_torch.federated.strategies.base`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import fedadp as fedadp_mod
from repro_torch.core import selection as sel
from repro_torch.federated.strategies.base import (FLStrategy,
                                                   register_strategy)


# ----------------------------------------------------------------------
# Per-strategy options (``FLConfig(algo_options=...)``). Validation lives
# next to the knob's owner; FLConfig folds the deprecated flat fields
# (fedadp_keep, fedlp_p, ...) into these.
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FedADPOptions:
    """FedADP knobs: ``keep`` — the neuron keep fraction (equal-comm
    setting vs FedLDF's n/K)."""
    keep: float = 0.2

    def __post_init__(self):
        if not 0.0 < self.keep <= 1.0:
            raise ValueError(
                f"fedadp keep fraction must be in (0, 1], got {self.keep}")


@dataclasses.dataclass(frozen=True)
class FedLPOptions:
    """FedLP knobs: ``p`` — per-layer keep probability."""
    p: float = 0.5

    def __post_init__(self):
        if not 0.0 < self.p <= 1.0:
            raise ValueError(
                f"fedlp_p must be in (0, 1], got {self.p}")


def _need_stream(uniform, name):
    if uniform is None:
        raise ValueError(
            f"strategy {name!r} draws from the round's algorithm stream; "
            "pass the round function uniform=... (the drivers do)")
    return uniform


@register_strategy("fedldf")
class FedLDF(FLStrategy):
    """The paper's algorithm: top-n clients per layer-unit by divergence
    (Eq. 4), Eq. 5 aggregation, divergence-feedback uplink accounted."""

    needs_divergence = True

    def select(self, divs, uniform, k, u, n, device):
        return sel.topn_divergence(divs, n)


@register_strategy("fedavg")
class FedAvg(FLStrategy):
    """Eq. 1: full participation, everything uploaded."""

    def select(self, divs, uniform, k, u, n, device):
        return sel.full_participation(k, u, device)


@register_strategy("random")
class RandomPerLayer(FLStrategy):
    """Random baseline: per unit, n uniform clients upload."""

    def select(self, divs, uniform, k, u, n, device):
        return sel.random_per_layer(_need_stream(uniform, self.name), k, u,
                                    n)


@register_strategy("hdfl")
class HDFL(FLStrategy):
    """HDFL [7]: n whole clients participate, uploading all units."""

    def select(self, divs, uniform, k, u, n, device):
        return sel.client_dropout(_need_stream(uniform, self.name), k, u, n)


@register_strategy("fedadp")
class FedADP(FLStrategy):
    """FedADP [6]: per-client neuron-granularity pruning with element-wise
    masked aggregation — not an Eq. 5 selection scheme, so it overrides
    :meth:`aggregate` wholesale. Works in ``vmap`` mode and in ``scan``
    mode (the scan round stacks the sequentially trained locals and feeds
    them to the same hook)."""

    options_cls = FedADPOptions
    eq5_weighted = False        # element-wise masks, not unit weights
    supports_quantize = False   # aggregates pruned neurons, not deltas

    def select(self, divs, uniform, k, u, n, device):
        # selection is accounting-only for FedADP: pruning happens at
        # neuron granularity inside aggregate()
        return sel.full_participation(k, u, device)

    def aggregate(self, uploads, umap, selection, data_sizes,
                  global_params):
        return fedadp_mod.aggregate_fedadp(uploads, global_params,
                                           data_sizes, self.opts.keep)

    # ---- mesh halves: per-leaf additive masked partials ----
    def psum_parts(self, uploads, umap, sel_loc, data_sizes,
                   global_params=None):
        if global_params is None:
            raise ValueError("fedadp psum_parts needs the global model for "
                             "its masks")
        return fedadp_mod.fedadp_psum_parts(uploads, global_params,
                                            data_sizes, self.opts.keep)

    def psum_finalize(self, parts, denom, umap, params, fallback):
        return fedadp_mod.fedadp_psum_finalize(parts, denom, fallback)

    def comm_profile(self, selection, umap, param_bytes_override=None,
                     unit_bytes_override=None):
        comm = comm_mod.round_comm(selection, umap,
                                   divergence_feedback=False)
        # FedADP's own accounting; the payload is recomputed with the total
        # so that payload + feedback == total
        comm["uplink_total"] = comm["fedavg_uplink"] * self.opts.keep
        comm["uplink_payload"] = comm["uplink_total"] \
            - comm["uplink_feedback"]
        comm["savings_frac"] = torch.full(
            (), 1.0 - self.opts.keep, dtype=torch.float32,
            device=selection.device)
        return comm


@register_strategy("fedlp")
class FedLP(FLStrategy):
    """FedLP (Zhu et al., arXiv:2303.06360): layer-wise probabilistic
    participation. Each client independently keeps (uploads) each
    layer-unit with probability ``FedLPOptions.p``; the server runs the
    usual Eq. 5 weighted mean over whatever arrived, falling back to the
    previous global value for units nobody kept. Expected uplink is
    ``p × FedAvg`` with zero feedback traffic — the comm profile adds only
    the per-client keep-mask header (U bits a client, byte-padded)."""

    options_cls = FedLPOptions

    def select(self, divs, uniform, k, u, n, device):
        return sel.bernoulli_per_layer(_need_stream(uniform, self.name), k,
                                       u, self.opts.p)

    def comm_profile(self, selection, umap, param_bytes_override=None,
                     unit_bytes_override=None):
        stats = comm_mod.round_comm(
            selection, umap, divergence_feedback=False,
            param_bytes_override=param_bytes_override,
            unit_bytes_override=unit_bytes_override)
        mask_bytes = torch.full(
            (), selection.shape[0] * ((umap.num_units + 7) // 8),
            dtype=torch.float32, device=selection.device)
        stats["uplink_feedback"] = stats["uplink_feedback"] + mask_bytes
        stats["uplink_total"] = stats["uplink_total"] + mask_bytes
        stats["savings_frac"] = (1.0 - stats["uplink_total"]
                                 / stats["fedavg_uplink"])
        return stats
