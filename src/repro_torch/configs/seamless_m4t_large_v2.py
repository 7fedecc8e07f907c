"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206, encoder-decoder, multimodal. [arXiv:2308.11596]

Per the assignment the modality frontend (mel-spectrogram + conv feature
extractor / w2v-BERT speech encoder frontend) is a STUB: ``input_specs()``
provides precomputed frame embeddings (frontend_dim=1024). The transformer
encoder-decoder backbone is implemented in full (the conformer encoder is
simplified to a transformer encoder; DESIGN.md §8).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,           # decoder
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        frontend_dim=1024,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        source="arXiv:2308.11596 (SeamlessM4T large v2)",
    )
