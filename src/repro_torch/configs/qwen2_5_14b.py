"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="hf:Qwen/Qwen2.5-0.5B (family card; 14B config)",
    )
