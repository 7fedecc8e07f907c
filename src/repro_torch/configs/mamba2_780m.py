"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) d_ff=0
vocab=50280, ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,                 # Mamba-2 blocks have no separate MLP
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,        # d_inner = 3072 -> 48 SSD heads
        ssm_expand=2,
        ssm_chunk=128,
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="arXiv:2405.21060 (Mamba-2 780m)",
    )
