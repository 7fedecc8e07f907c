"""Named performance variants, port of ``repro.launch.variants``.

Each variant is (config transform, sharding-override builder). The
dry-run (:mod:`repro_torch.launch.dryrun`) applies a variant on top of the
baseline and counts again. The config transforms are the reference's. The
overrides are the port's tuple specs (:mod:`repro_torch.launch.sharding`),
each equal to ``tuple()`` of the reference's ``PartitionSpec``; on one
card they change only the dry-run's per-device argument bytes on the
production mesh (``memory_per_device["argument_size_in_bytes_sharded"]``).

Baseline auto-sharding recap (launch/sharding.py): largest divisible dim →
'model', next → data axes; caches: W(seq) → 'model' and, because of the
max-size/tie rule, head_dim often lands on 'data' instead of batch. The
hypotheses below are quoted as the reference states them, formed from its
lowered IR on its TPU v5e mesh: the sizes and ratios in them are the
reference's, not measurements of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.launch.sharding import data_axis_entry
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    hypothesis: str
    cfg_fn: Callable[[ModelConfig], ModelConfig] = lambda c: c
    overrides_fn: Optional[Callable[[ModelConfig, tuple], dict]] = None
    # overrides_fn(cfg, data_axes) -> {path-regex: spec tuple}


def _remat(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, remat_blocks=True)


def _remat_flash_tune(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, remat_blocks=True, attn_chunk=4096,
                               attn_probs_bf16=True)


def _head_pad(cfg: ModelConfig) -> ModelConfig:
    """Megatron-style head padding: round heads up to 16 so attention
    shards instead of replicating (hymba's 25H/5KV). Adds dead parameters:
    a perf variant, not the faithful config."""
    if cfg.num_heads % 16 == 0 and (cfg.num_kv_heads % 16 == 0
                                    or cfg.num_kv_heads == 0):
        return cfg
    nh = -(-cfg.num_heads // 16) * 16
    nkv = cfg.num_kv_heads
    while nh % nkv or nkv % 2 and nkv < nh:  # keep GQA divisibility
        nkv += 1
    return dataclasses.replace(cfg, num_heads=nh, num_kv_heads=nkv)


def _remat_flash_headpad(cfg: ModelConfig) -> ModelConfig:
    return _head_pad(_remat_flash_tune(cfg))


def _cache_batch_overrides(cfg: ModelConfig, daxes) -> dict:
    """Pin KV cache to (L, B→data, W, KV, hd→model): keeps the ring-buffer
    update local to a device."""
    d = data_axis_entry(daxes)
    return {
        r"^(k|v)$": (None, d, None, None, "model"),
        r"^(cross_k|cross_v)$": (None, d, None, None, "model"),
    }


def _cache_seq_overrides(cfg: ModelConfig, daxes) -> dict:
    """Pin KV cache W→data (flash-decoding style sequence parallelism) with
    hd→model; for long_500k (B=1) the batch axis cannot shard."""
    d = data_axis_entry(daxes)
    return {
        r"^(k|v)$": (None, None, d, None, "model"),
        r"^(cross_k|cross_v)$": (None, None, d, None, "model"),
    }


def _expert_parallel_overrides(cfg: ModelConfig, daxes) -> dict:
    """Experts → 'model' (true expert parallelism) instead of the
    baseline's tensor-parallel-within-every-expert layout."""
    d = data_axis_entry(daxes)
    return {
        r"moe/w_(gate|up)$": (None, "model", d, None),
        r"moe/w_down$": (None, "model", None, d),
    }


def _ssm_proj_overrides(cfg: ModelConfig, daxes) -> dict:
    """SSM projections: column-parallel in_proj and row-parallel
    out_proj."""
    return {
        # leaves live under the stacked 'blocks' key: leading depth dim
        r"ssm/in_proj$": (None, None, "model"),
        r"ssm/out_proj$": (None, "model", None),
        r"ssm/conv_w$": (None, None, "model"),
    }


def _megatron_overrides(cfg: ModelConfig, daxes) -> dict:
    """Classic Megatron column/row-parallel TP for all block weights
    (contraction dims replicated over 'data')."""
    return {
        r"attn/w[qkv]$|mlp/w_(gate|up)$|shared/w_(gate|up)$":
            (None, None, "model"),
        r"attn/wo$|mlp/w_down$|shared/w_down$": (None, "model", None),
        r"attn/b[qkv]$": (None, "model"),
        r"cross/w[qkv]$": (None, None, "model"),
        r"cross/wo$": (None, "model", None),
        r"ssm/in_proj$|ssm/conv_w$": (None, None, "model"),
        r"ssm/out_proj$": (None, "model", None),
        r"embed/tok$": ("model", None),
        r"final/head$": (None, "model"),
        r"enc_embed/proj$": (None, "model"),
    }


def _moe_full_overrides(cfg: ModelConfig, daxes) -> dict:
    return {
        **_expert_parallel_overrides(cfg, daxes),
        r"attn/w[qkv]$": (None, None, "model"),
        r"attn/wo$": (None, "model", None),
        r"embed/tok$": ("model", None),
        r"final/head$": (None, "model"),
    }


VARIANTS: dict[str, Variant] = {
    "megatron": Variant(
        "megatron",
        "Replace FSDP-everywhere with Megatron column/row TP: kills the "
        "per-matmul partial-sum all-reduces the baseline pays on every "
        "FSDP-sharded contraction dim.",
        overrides_fn=_megatron_overrides),
    "remat+flash_tune+megatron": Variant(
        "remat+flash_tune+megatron",
        "All three levers for the dense train pair.",
        cfg_fn=_remat_flash_tune,
        overrides_fn=_megatron_overrides),
    "ssm_proj": Variant(
        "ssm_proj",
        "Column-parallel SSM in_proj (no FSDP on the contraction dim) kills "
        "the post-dot all-reduce; fused-split permutes may remain.",
        overrides_fn=_ssm_proj_overrides),
    "remat": Variant(
        "remat",
        "Block-boundary activation checkpointing cuts train-round HBM "
        "traffic/residency (memory term) at ~1.3× compute; dominant term is "
        "memory, so net win expected.",
        cfg_fn=_remat),
    "cache_batch": Variant(
        "cache_batch",
        "KV cache sharded B→data, hd→model keeps decode-scan ring-buffer "
        "updates device-local; removes the involuntary-remat copies "
        "(collective + memory terms).",
        overrides_fn=_cache_batch_overrides),
    "cache_seq": Variant(
        "cache_seq",
        "KV cache W→data parallelises the 500k-context window across chips "
        "when batch=1 (collective term trades against idle chips).",
        overrides_fn=_cache_seq_overrides),
    "expert_parallel": Variant(
        "expert_parallel",
        "E→model expert parallelism turns per-expert tensor-parallel matmul "
        "fragments into whole-expert local matmuls + one all-to-all; for "
        "top-1/128e the dispatch volume ≪ weight-gather volume.",
        overrides_fn=_expert_parallel_overrides),
    "remat+flash_tune": Variant(
        "remat+flash_tune",
        "After remat, flash-attention probability/carry tensors dominate "
        "HBM traffic under XLA lowering (scores hit HBM, unlike a fused "
        "Pallas kernel). bf16 probabilities halve the biggest tensor; a "
        "4096 KV chunk quarters the o-carry rewrites.",
        cfg_fn=_remat_flash_tune),
    "remat+flash_tune+head_pad": Variant(
        "remat+flash_tune+head_pad",
        "Indivisible head counts (hymba 25H/5KV vs model=16) force "
        "replicated attention compute; padding to 32H/8KV lets GSPMD shard "
        "heads (8-way on KV) — trades dead parameters for 16× less "
        "redundant attention FLOPs.",
        cfg_fn=_remat_flash_headpad),
    "remat+flash_tune+expert_parallel": Variant(
        "remat+flash_tune+expert_parallel",
        "Compose all three levers for the MoE train pair.",
        cfg_fn=_remat_flash_tune,
        overrides_fn=_expert_parallel_overrides),
    "moe_full": Variant(
        "moe_full",
        "400B-MoE composition: EP for experts, Megatron TP for attention "
        "(10 GB/chip replicated — fits), FSDP kept on the shared expert "
        "(full TP replication would need 22 GB/chip > v5e HBM), remat + "
        "flash_tune.",
        cfg_fn=_remat_flash_tune,
        overrides_fn=_moe_full_overrides),
    "remat+expert_parallel": Variant(
        "remat+expert_parallel",
        "Remat fixed the memory term; the dominant term is now collective "
        "(expert-weight gathers). E→model expert parallelism keeps expert "
        "weights local and moves only the top-1 token dispatch.",
        cfg_fn=_remat,
        overrides_fn=_expert_parallel_overrides),
    "remat+cache_batch": Variant(
        "remat+cache_batch",
        "Compose the two wins (train shapes also carry no KV cache, so this "
        "equals remat there; kept for decode+train sweeps).",
        cfg_fn=_remat,
        overrides_fn=_cache_batch_overrides),
}


def apply_variant(name: str, cfg: ModelConfig, daxes) -> tuple[ModelConfig,
                                                               Optional[dict]]:
    v = VARIANTS[name]
    cfg2 = v.cfg_fn(cfg)
    ov = v.overrides_fn(cfg2, daxes) if v.overrides_fn else None
    return cfg2, ov
