"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, GQA + QKV bias.  [hf:Qwen/Qwen2.5-0.5B family; hf]

TP note: 40 q-heads padded to 48 for the 16-way model axis; 8 KV heads are
GQA-replicated across TP (decode KV cache shards on the sequence dim via
flash-decoding instead — dist/sharding.py ``kv_seq`` rule)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=27648, vocab_size=152064, head_dim=128,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e6,
        pad_heads_to=48,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=192, vocab_size=256, head_dim=8,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e4,
    )
