"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B
family; hf]

The scale driver of the fleet: ~235B total / ~22B active parameters.  128
experts shard 8-per-chip over the 16-way model axis (EP); KV (4 heads) is
GQA-replicated with flash-decoding KV-seq sharding at decode."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        d_ff=1536, vocab_size=151936, head_dim=128,
        qkv_bias=False, tie_embeddings=False, rope_theta=1e6,
        num_experts=128, experts_per_token=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=64, vocab_size=256, head_dim=8,
        tie_embeddings=False, rope_theta=1e4,
        num_experts=8, experts_per_token=2, moe_capacity_factor=100.0,
    )
