"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=13440 vocab=92416 — qwen1.5 arch.  [hf:Qwen/CodeQwen1.5-7B; hf]

32 heads divide the 16-way model axis cleanly (2/chip); d_ff 13440 = 16·840;
vocab 92416 = 16·5776 — no padding needed anywhere."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=13440, vocab_size=92416, head_dim=128,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=112, vocab_size=256, head_dim=16,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e4,
    )
