"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE + dynamic resolution. [arXiv:2409.12191]

Vision tower (ViT) is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (frontend_dim=1280, the Qwen2-VL ViT width);
the language backbone fuses them into the token stream (early fusion) and is
implemented in full, including M-RoPE with sections (16, 24, 24).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        mrope=True,
        mrope_sections=(16, 24, 24),   # Σ = 64 = head_dim/2
        frontend_dim=1280,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="arXiv:2409.12191 (Qwen2-VL-2B)",
    )
