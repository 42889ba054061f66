"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

vocab 49155 = 3·16385 is not divisible by the 16-way model axis; the embedding
pads to 49168 internally (logits over pad ids masked to -inf)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        qkv_bias=False, tie_embeddings=True, rope_theta=1e4,
        num_experts=32, experts_per_token=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=256, head_dim=16,
        tie_embeddings=True, rope_theta=1e4,
        num_experts=4, experts_per_token=2, moe_capacity_factor=100.0,
    )
