"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
(per expert), vocab=102400, 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066]

Simplification (DESIGN.md §8): DeepSeekMoE keeps its first layer dense; here
all layers are MoE with the assigned 2-shared + 64-routed top-6 structure.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        num_experts=64,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        capacity_factor=1.25,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="arXiv:2401.06066 (DeepSeekMoE 16B)",
    )
