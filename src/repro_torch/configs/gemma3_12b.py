"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local:global attention (1024-token sliding window on local
layers), 128k context.  head_dim=256 per the gemma3 family convention.
[hf:google/gemma-3-1b-pt family; unverified]

Sub-quadratic eligible: only every 6th layer holds full-length KV, so
long_500k decode is runnable (global layers use flash-decoding KV-seq
sharding; local layers hold a 1024-slot ring buffer)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        d_ff=15360, vocab_size=262144, head_dim=256,
        qkv_bias=False, tie_embeddings=True, rope_theta=1e6,
        local_window=1024, pattern_local=5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        tie_embeddings=True, rope_theta=1e4,
        local_window=8, pattern_local=5,
    )
