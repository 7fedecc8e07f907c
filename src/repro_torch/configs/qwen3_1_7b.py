"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="hf:Qwen/Qwen3-8B (family card; 1.7B config)",
    )
