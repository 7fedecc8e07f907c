"""granite-4.0-h-small [hybrid_moe] — 40L d_model=4096; 36 Mamba-2 layers
(128 heads of 64, state 128, one B/C group, chunk 256, conv 4 with bias,
expand 2) and 4 NoPE GQA layers (32 / 8 heads of 128, no bias, score scale
1/128) at 5, 15, 25, 35; in every layer 72 routed SwiGLU experts of 768,
top-10 (softmax over the top-k logits, dropless), and a shared SwiGLU of
1536; μP multipliers ×12 (embedding), ×0.22 (each residual branch), ÷16
(logits); rms eps 1e-5; tied vocabulary 100,352; bf16.
[hf:ibm-granite/granite-4.0-h-small config.json]

The shared expert's width is a field of its own (``shared_d_ff``), not
``num_shared_experts · moe_d_ff``. Serving is not implemented for the
patterned stack (``models/decode.py`` raises).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small",
        family="hybrid_moe",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=100352,
        nope=True,
        attention_multiplier=0.0078125,
        num_experts=72,
        num_shared_experts=1,
        moe_top_k=10,
        moe_d_ff=768,
        shared_d_ff=1536,
        moe_dropless=True,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_conv_width=4,
        attn_period=10,
        attn_offset=5,
        tie_embeddings=True,
        norm_eps=1e-5,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="hf:ibm-granite/granite-4.0-h-small (config.json)",
    )
