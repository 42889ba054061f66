"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention blocks.
[arXiv:2411.15242; hf]

Realization (DESIGN.md §6): 38 Mamba2 blocks; ONE shared (attention + MLP)
block whose parameters are reused at every 6th position (6 invocations) —
the Zamba2 weight-sharing idea.  32 heads × 64 head_dim = 2048 = d_model.
Hybrid ⇒ long_500k runnable: SSM state is O(1); the shared-attention KV at
6 invocations uses flash-decoding KV-seq sharding."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        tie_embeddings=True, rope_theta=1e4,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        conv_width=4, ssm_chunk=256,
        shared_attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        tie_embeddings=True, rope_theta=1e4,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
        conv_width=4, ssm_chunk=16,
        shared_attn_every=2,
    )
