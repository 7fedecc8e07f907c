"""LoRA-style adapters over the transformer zoo, port of
``repro.models.lora`` [arXiv:2106.09685 idiom].

:func:`inject_lora` drops low-rank factor pairs ``{"a": (L, d_in, r),
"b": (L, r, d_out)}`` next to the stacked dense projections they adapt
(``blocks["attn"]["lora"]["wq"]``, ...). ``b`` is zero, so the adapted
forward equals the base forward bit for bit at injection time; training
moves only the factors. The forward hookup is
:func:`repro_torch.models.layers.lora_dense`.

With :func:`lora_partition` (a
:class:`~repro_torch.core.partition.ParamPartition`) this is the
adapter-only uplink: the frozen base stays on the device, the wire carries
factors only, and FedLDF's Eq. 3 scores per-depth adapter units (the
stacked (L, ...) axis gives the ``blocks/i`` units of
:class:`~repro_torch.core.units.UnitMap`).

Adapted projections per block module (only those present are touched):

    attn: wq wk wv wo          (dense / moe / hybrid / enc / dec families)
    mlp:  w_gate w_up w_down   (all non-moe FFN blocks)
    ssm:  in_proj out_proj     (mamba2 / hybrid families)

The factors are drawn from an explicit ``torch.Generator``; their values
differ from the reference's ``jax.random`` draws (parity tests carry the
reference's injected params across with
:func:`repro_torch.bridge.params_from_numpy`).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Tuple

import torch

from repro_torch.core.partition import ParamPartition

Pytree = Any

# module-name -> projection names eligible for adapters (ndim-3 stacked
# (L, d_in, d_out) leaves only; missing modules/names are skipped).
LORA_TARGETS: Mapping[str, Tuple[str, ...]] = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
    "ssm": ("in_proj", "out_proj"),
}

# stacked-block subtrees adapters may live under (see transformer.init_params)
LORA_SUBTREES: Tuple[str, ...] = ("blocks", "enc_blocks")


def inject_lora(params: Pytree, rank: int, generator: torch.Generator,
                targets: Optional[Mapping[str, Tuple[str, ...]]] = None,
                subtrees: Tuple[str, ...] = LORA_SUBTREES) -> Pytree:
    """Returns a copy of ``params`` (sharing the base tensors) with adapter
    factors injected.

    ``rank`` is clipped per projection to ``min(rank, d_in, d_out)``.
    ``a ~ N(0, 1/d_in)`` in the projection's dtype, drawn on
    ``generator``'s device (in the reference's projection order) and
    placed beside the projection; ``b`` is zeros. Raises ``ValueError``
    for ``rank < 1`` and when no eligible projection exists (an empty
    adapter set would make the trainable partition empty).
    """
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    targets = LORA_TARGETS if targets is None else targets
    out = dict(params)
    injected = 0
    for sub in subtrees:
        if sub not in params:
            continue
        blocks = dict(params[sub])
        for mod, projs in targets.items():
            if mod not in blocks:
                continue
            mdict = dict(blocks[mod])
            lora = dict(mdict.get("lora", {}))
            for name in projs:
                w = mdict.get(name)
                if w is None or getattr(w, "ndim", 0) != 3:
                    continue
                depth, din, dout = w.shape
                r = min(rank, din, dout)
                a = torch.randn((depth, din, r), generator=generator,
                                device=generator.device) / math.sqrt(din)
                lora[name] = {
                    "a": a.to(device=w.device, dtype=w.dtype),
                    "b": torch.zeros((depth, r, dout), dtype=w.dtype,
                                     device=w.device)}
                injected += 1
            if lora:
                mdict["lora"] = lora
                blocks[mod] = mdict
        out[sub] = blocks
    if injected == 0:
        raise ValueError(
            "inject_lora found no eligible projection: params has none of "
            f"{sorted(targets)} with stacked (L, d_in, d_out) leaves under "
            f"{subtrees}")
    return out


def lora_partition(params: Pytree) -> ParamPartition:
    """Trainable = every leaf under a ``lora`` path segment; rest frozen.

    Pass the result as ``FLConfig(partition=...)`` for the adapter-only
    uplink: the base model never travels the wire.
    """
    return ParamPartition.by_substring(params, "lora")
