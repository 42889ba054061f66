"""seamless-m4t-large-v2 [audio] — enc-dec, 24L (each side) d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

The modality frontend (speech encoder feature extractor) is a STUB:
``input_specs()`` provides precomputed frame embeddings ``src_embeds``
(B, S//8, d) — the transformer backbone (conformer-less simplification) is
what we lower.  Decode shapes lower the *decoder* serve_step with
precomputed encoder output as cross-attention memory."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        num_layers=24, encoder_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=256206, head_dim=64,
        qkv_bias=False, tie_embeddings=True, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec",
        num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=254, head_dim=16,
        tie_embeddings=True, rope_theta=1e4,
    )
