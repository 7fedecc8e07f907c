"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (per expert), vocab=202048, MoE 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family card]

Simplification (DESIGN.md §8): Maverick interleaves dense and MoE layers;
here every layer is MoE with 1 shared + 128 routed top-1 experts, matching
the assigned dims. FedLDF beyond-paper option: ``expert_units=True`` treats
the expert bank as divergence units for expert-granular selective upload.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,              # shared-expert width
        vocab_size=202048,
        num_experts=128,
        num_shared_experts=1,
        moe_top_k=1,
        moe_d_ff=8192,
        capacity_factor=1.25,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="hf:meta-llama/Llama-4-Scout-17B-16E (family card; Maverick dims)",
    )
