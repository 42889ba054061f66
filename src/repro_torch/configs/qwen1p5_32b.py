"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40, i.e. MHA) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]

TP note: 40 heads don't divide the 16-way ``model`` axis; we pad heads to 48
(Megatron-style zero-head padding, documented in DESIGN.md §Sharding).  FLOP
accounting uses the true 40 heads, so the padding waste shows up in the
MODEL_FLOPS / HLO_FLOPs ratio of the roofline table rather than hiding.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
        d_ff=27392, vocab_size=152064, head_dim=128,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e6,
        pad_heads_to=48, pad_kv_to=48,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, head_dim=16,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e4,
    )
