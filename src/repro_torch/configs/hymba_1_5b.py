"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads in each block.
[arXiv:2411.13676]

Simplifications recorded in DESIGN.md §8: meta-tokens and the per-layer
sliding/global attention mix are replaced by full attention in every block;
the parallel attn ∥ SSM head structure (the paper's core idea) is kept.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,          # 25 × 64 = 1600
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="arXiv:2411.13676 (Hymba-1.5B)",
    )
