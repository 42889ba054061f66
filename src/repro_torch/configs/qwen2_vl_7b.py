"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

The vision frontend (ViT + merger) is a STUB: ``input_specs()`` provides
precomputed patch embeddings (B, n_patch, d) that the backbone scatters into
image-placeholder token positions.  M-RoPE: rotary dims split into
(temporal, height, width) sections [16, 24, 24] over head_dim/2 = 64.

TP note: 28 q-heads pad to 32 for the 16-way model axis (2/chip); 4 KV heads
GQA-replicate with KV-seq flash-decoding shards at decode."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064, head_dim=128,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        pad_heads_to=32,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e4,
        mrope_sections=(2, 3, 3),
    )
